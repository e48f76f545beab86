"""The resident draft model (engine/spec_draft.py,
``llama.draft_propose_layers``) against the JAX package's.

- ``draft_propose_layers`` on the debug-draft preset (1 layer; float32
  weights from one JAX init on both sides), over fixed f32 and int8 draft
  caches: several rounds of catch-up + K greedy steps with a dead row,
  rows at different frontiers and a rewind (a frontier below the last
  round's speculative rows). The proposals are equal, and so are the
  caches within f32 summation order (ATOL = 1e-5; int8 rows within a
  step, scales within an ulp).
- ``resolve_draft_config`` and ``attention_window`` equal JAX's, and the
  port refuses a draft checkpoint path naming queue 1 item 10.
- ``DraftRuntime``: admission prefill and a session of proposals over a
  shared tracker give JAX's frontiers; the proposals equal the model
  function run by hand.
- Engine level: a draft identical to the target (the debug preset drafting
  for itself, the same random weights) accepts every draft: more than
  two tokens a target dispatch, and the stream is spec-off's; on the JAX
  engine's target and draft weights the port's draft-model streams equal
  the JAX draft-model engine's (slow).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import spec_decode as jspec
from generativeaiexamples_tpu.engine import spec_draft as jdraft
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import spec_draft as tdraft
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.convert import params_from_jax

DCFG_J = jl.PRESETS["debug-draft"]
DCFG_T = tl.PRESETS["debug-draft"]
S = DCFG_J.max_seq_len
B = 4
K = 4
V = 300  # a sampling vocab below the draft's 512: the argmax is bounded
ATOL = 1e-5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def draft_weights():
    stacked = jl.init_params(DCFG_J, jax.random.PRNGKey(3), jnp.float32)
    port = params_from_jax(stacked)
    return jl.consume_split_params_layers(stacked), port


def _assert_caches(tc, jc):
    for t, j in zip(tc, jc):
        for key in t:
            mine, ref = t[key], np.asarray(j[key])
            if key in ("ks", "vs"):
                np.testing.assert_allclose(_np(mine), ref, rtol=1e-5, atol=0, err_msg=key)
            elif mine.dtype == torch.int8:
                assert np.abs(mine.numpy().astype(np.int32) - ref.astype(np.int32)).max() <= 1, key
            else:
                np.testing.assert_allclose(_np(mine), ref, rtol=0, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_draft_propose_layers_equals_jax(draft_weights, quantized):
    jparams, port = draft_weights
    rng = np.random.default_rng(0)
    jc = jl.init_kv_cache_layers(DCFG_J, B, S, jnp.float32, quantized=quantized)
    tc = tl.init_kv_cache_layers(DCFG_T, B, S, torch.float32, quantized=quantized)
    # prompts of 9, 20 and 14 ids on slots 0-2, slot 3 dead
    lengths = np.asarray([9, 20, 14, 0], np.int32)
    prompt = rng.integers(0, DCFG_J.vocab_size, (B, 32)).astype(np.int32)
    slots = np.arange(B, dtype=np.int32)
    zeros = np.zeros(B, np.int32)
    _, jc = jl.extend_layers(jparams, DCFG_J, jnp.asarray(prompt), jnp.asarray(zeros),
                             jnp.asarray(lengths), jnp.asarray(slots), jc, 32)
    tl.extend_layers(port, DCFG_T, torch.from_numpy(prompt).long(), torch.from_numpy(zeros).long(),
                     torch.from_numpy(lengths).long(), torch.from_numpy(slots).long(), tc, 32)
    fed = lengths.copy()
    # round 1 feeds each live row's first target token; later rounds feed
    # accepted + bonus (1 .. K + 1) from a frontier that rewinds over the
    # last round's rejected speculative rows
    pending = [np.asarray([1, 1, 1, 0]), np.asarray([K + 1, 1, 3, 0]), np.asarray([2, K + 1, 1, 0])]
    for valid in pending:
        chunk = np.zeros((B, K + 1), np.int32)
        for b in range(B):
            chunk[b, : valid[b]] = rng.integers(0, V, valid[b])
        valid = valid.astype(np.int32)
        window = jdraft.attention_window(int((fed + valid).max()) + K + 1, S)
        ref, jc = jl.draft_propose_layers(
            jparams, DCFG_J, jnp.asarray(chunk), jnp.asarray(fed), jnp.asarray(valid), jc,
            window, draft_k=K, vocab=V)
        out, caches = tl.draft_propose_layers(
            port, DCFG_T, torch.from_numpy(chunk).long(), torch.from_numpy(fed).long(),
            torch.from_numpy(valid).long(), tc, window, draft_k=K, vocab=V)
        assert caches is tc and tuple(out.shape) == (B, K)
        np.testing.assert_array_equal(out.numpy()[:3], np.asarray(ref)[:3])
        assert int(out.max()) < V
        fed = fed + valid
    _assert_caches(tc, jc)


def test_draft_propose_layers_single_step(draft_weights):
    """draft_k = 1: the catch-up's argmax alone."""
    jparams, port = draft_weights
    jc = jl.init_kv_cache_layers(DCFG_J, 2, S, jnp.float32)
    tc = tl.init_kv_cache_layers(DCFG_T, 2, S, torch.float32)
    chunk = np.asarray([[5, 6, 7], [9, 0, 0]], np.int32)
    offsets, valid = np.asarray([0, 0], np.int32), np.asarray([3, 1], np.int32)
    ref, _ = jl.draft_propose_layers(jparams, DCFG_J, jnp.asarray(chunk), jnp.asarray(offsets),
                                     jnp.asarray(valid), jc, 128, draft_k=1, vocab=V)
    out, _ = tl.draft_propose_layers(port, DCFG_T, torch.from_numpy(chunk).long(),
                                     torch.from_numpy(offsets).long(),
                                     torch.from_numpy(valid).long(), tc, 128, draft_k=1, vocab=V)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_resolve_draft_config_and_window_equal_jax():
    for name in ("debug-draft", "llama3-1b-proxy", "debug"):
        cfg = EngineConfig(spec_draft_model=name)
        assert tdraft.resolve_draft_config(cfg).__dict__ == \
            jdraft.resolve_draft_config(JaxEngineConfig(spec_draft_model=name)).__dict__
    with pytest.raises(ValueError) as want:
        jdraft.resolve_draft_config(JaxEngineConfig(spec_draft_model="no-such-preset"))
    with pytest.raises(ValueError) as got:
        tdraft.resolve_draft_config(EngineConfig(spec_draft_model="no-such-preset"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="queue 1 item 10"):
        tdraft.resolve_draft_config(EngineConfig(spec_draft_checkpoint_path="/ckpt"))
    with pytest.raises(ValueError, match="queue 1 item 10"):
        EngineConfig(spec_proposer="draft_model", spec_draft_checkpoint_path="/ckpt").validate()
    for needed in (1, 127, 128, 129, 300, 1000, 5000):
        for cap in (128, 256, 1024, 8192):
            assert tdraft.attention_window(needed, cap) == jdraft.attention_window(needed, cap)


def test_draft_runtime_session_matches_the_model_function(draft_weights):
    """Admission prefill, then rounds with accepted spans: the runtime's
    proposals equal ``draft_propose_layers`` run by hand on a copy of its
    caches, and its tracker's frontiers follow JAX's ``DraftTracker``."""
    _, port = draft_weights
    cfg = EngineConfig(spec_draft_model="debug-draft", spec_proposer="draft_model",
                       spec_draft_len=K, prefill_chunk=16)
    rt = tdraft.DraftRuntime(cfg, device=torch.device("cpu"), dtype=torch.float32,
                             sample_vocab=V, num_slots=B, max_seq_len=S, params=port)
    ref_tracker = jspec.DraftTracker(K)
    rng = np.random.default_rng(5)
    lengths = np.asarray([9, 20, 14], np.int64)
    tokens = np.zeros((3, 32), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, V, n)
    slots = [2, 0, 3]
    eligible = np.asarray([True, True, False])
    rt.prefill_wave(tokens, lengths, slots, eligible)
    ctx = {}
    for i, slot in enumerate(slots):
        if eligible[i]:
            rt.on_admit(slot, int(lengths[i]))
            ref_tracker.on_admit(slot, int(lengths[i]))
            ctx[slot] = list(tokens[i, : lengths[i]]) + [int(rng.integers(0, V))]
    hand = [{k: v.clone() for k, v in c.items()} for c in rt._caches]
    for rnd in range(4):
        rows = [(slot, ctx[slot], 3 if slot == 2 else K) for slot in sorted(ctx)]
        chunk = np.zeros((B, K + 1), np.int64)
        offsets = np.zeros(B, np.int64)
        valid = np.zeros(B, np.int64)
        for slot, c, _ in rows:
            fed, pend = ref_tracker.begin_round(slot, len(c))
            chunk[slot, :pend] = c[fed:]
            offsets[slot], valid[slot] = fed, pend
            ref_tracker.mark_fed(slot, len(c))
        window = tdraft.attention_window(
            min(int((offsets + valid).max()) + K + 1, S), S)
        want, _ = tl.draft_propose_layers(
            port, DCFG_T, torch.from_numpy(chunk), torch.from_numpy(offsets),
            torch.from_numpy(valid), hand, window, draft_k=K, vocab=V)
        got = rt.propose(rows)
        for slot, _, cap in rows:
            assert got[slot] == want[slot, :cap].tolist(), (rnd, slot)
            assert rt.tracker._fed[slot] == ref_tracker._fed[slot]
            # accept a prefix of the proposal, then the bonus token
            n = int(rng.integers(0, cap + 1))
            ctx[slot] = ctx[slot] + got[slot][:n] + [int(rng.integers(0, V))]
    rt.on_release(2)
    assert not rt.tracker.tracked(2) and rt.tracker.tracked(0)
    rt.reset()
    assert not rt.tracker.tracked(0)
    assert rt.cache_bytes() == sum(t.numel() * 4 for c in rt._caches for t in c.values())


def test_a_draft_equal_to_the_target_accepts_every_draft():
    """The debug preset drafting for itself from the same random weights:
    every draft is accepted, more than two tokens a target dispatch, the
    stream is spec-off's, and the draft model's dispatches are counted."""
    tiny = dict(model_config_name="debug", max_batch_size=2, max_seq_len=128, prefill_chunk=16,
                decode_block=1, dtype="float32", kv_layout="paged", page_size=16)
    prompt = [(i * 37 + (i * i) % 91) % 199 + 1 for i in range(24)]
    params = SamplingParams(temperature=0.0, max_tokens=48)
    off = LLMEngine(EngineConfig(**tiny), device="cpu")
    try:
        ref = list(off.iter_ids(prompt, params, timeout=60))
    finally:
        off.shutdown()
    on = LLMEngine(EngineConfig(**tiny, spec_decode_enable="on", spec_proposer="draft_model",
                                spec_draft_model="debug"), device="cpu")
    try:
        s0 = on.stats()
        out = list(on.iter_ids(prompt, params, timeout=60))
        s1 = on.stats()
        assert out == ref
        drafted = s1["spec_drafted_tokens"] - s0["spec_drafted_tokens"]
        accepted = s1["spec_accepted_tokens"] - s0["spec_accepted_tokens"]
        dispatches = s1["decode_dispatches"] - s0["decode_dispatches"]
        assert drafted > 0 and accepted == drafted
        assert (len(out) - 1) / dispatches > 2.0
        assert s1["spec_draft_dispatches"] - s0["spec_draft_dispatches"] >= dispatches
    finally:
        on.shutdown()


PARITY = dict(model_config_name="debug", dtype="float32", max_batch_size=2, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=4, spec_decode_enable="on",
              spec_draft_model="debug-draft")


@pytest.mark.slow
@pytest.mark.parametrize("proposer", ["draft_model", "combined"])
@pytest.mark.parametrize("layout", ["paged", "fixed"])
def test_draft_streams_equal_the_jax_draft_engine(proposer, layout):
    kw = dict(PARITY, kv_layout=layout, spec_proposer=proposer)
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, **kw))
    port = LLMEngine(EngineConfig(**kw), device="cpu",
                     params=params_from_jax(jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)),
                     draft_params=params_from_jax(jax_engine._draft._params))
    copy = [3 + 10 * i for i in range(16)]
    normal = [(i * 37 + (i * i) % 91) % 199 + 1 for i in range(24)]
    try:
        for prompt, kw2 in ((copy, dict(temperature=0.0, max_tokens=40)),
                            (normal, dict(temperature=0.0, max_tokens=40)),
                            (normal, dict(temperature=0.7, top_p=0.8, max_tokens=24, seed=4242))):
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**kw2), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**kw2), timeout=600))
            assert out == ref, (prompt[:3], kw2)
        assert port.stats()["spec_draft_dispatches"] > 0
    finally:
        jax_engine.shutdown()
        port.shutdown()
