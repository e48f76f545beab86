"""Speculative decoding on a sharded engine (``mesh=`` of N ``cpu``
shards): the spec verify through each shard's tile, the lookup proposer
and the resident draft model on the engine's mesh.

- Port TP = 2 and 4 with ``spec_decode_enable`` on, on float32 weights,
  stream exactly what the one-shard engine streams with spec off (paged
  and fixed layouts; lookup, and the draft model on the target's own
  weights, every draft accepted), and the verifies really ran: the row
  reduce sums N f32 partials, so logits move by ~1e-6 and greedy and
  seeded streams are equal (no tolerance: token identity).
- The draft runtime on a TP=N engine holds its weights and strips as
  ``Shards`` of the target's cut (``draft_kv_cache_specs`` is the
  target's rule, the model axis where JAX's puts it); a draft whose heads
  do not divide the shards stays whole on the first device.
- The port at TP=2 with ``spec_decode_enable`` on equals the JAX engine at
  ``tensor_parallelism=2`` on W8A8 weights and an int8 page pool, the JAX
  engine's own weights carried over (token identity, as
  tests/test_torch_engine_tp.py holds plain serving).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel import create_mesh, sharding
from generativeaiexamples_tpu_torch.parallel.sharding import Shards

CFG = llama.PRESETS["debug-8dev"]
COMMON = dict(model_config_name="debug-8dev", dtype="float32", max_batch_size=4, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=4)
# a repeating prompt (lookup drafts and accepts on it), a plain one and a
# chunked one, greedy; the repeating one again seeded
REP_PROMPT = [5, 9, 13, 200] * 6
PLAIN_PROMPT = [(i * 7) % 250 + 1 for i in range(24)]
LONG_PROMPT = [256] + [(5 * i) % 250 for i in range(37)]
LEGS = [
    (REP_PROMPT, SamplingParams(temperature=0.0, max_tokens=40)),
    (PLAIN_PROMPT, SamplingParams(temperature=0.0, max_tokens=24)),
    (LONG_PROMPT, SamplingParams(temperature=0.0, max_tokens=24)),
    (REP_PROMPT, SamplingParams(temperature=0.8, top_p=0.9, max_tokens=24, seed=1234)),
]


def _mesh(n):
    return create_mesh(n, devices=["cpu"] * n)


def _streams(engine):
    return [list(engine.iter_ids(p, sp, timeout=120)) for p, sp in LEGS]


@pytest.fixture(scope="module")
def dense_weights():
    return llama.init_params(CFG, 0, torch.float32)


_OFF = {}


def _off_streams(dense_weights, layout):
    if layout not in _OFF:
        eng = LLMEngine(EngineConfig(kv_layout=layout, **COMMON), device="cpu", params=dense_weights)
        try:
            _OFF[layout] = _streams(eng)
        finally:
            eng.shutdown()
    return _OFF[layout]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("layout", ["paged", "fixed"])
@pytest.mark.parametrize("proposer", ["lookup", "draft_model"])
def test_tp_spec_streams_equal_one_shard_spec_off(dense_weights, n, layout, proposer):
    draft = proposer == "draft_model"
    cfg = EngineConfig(kv_layout=layout, spec_decode_enable="on", spec_proposer=proposer,
                       spec_draft_model="debug-8dev" if draft else "", **COMMON)
    eng = LLMEngine(cfg, params=dense_weights, draft_params=dense_weights if draft else None,
                    mesh=_mesh(n))
    try:
        assert eng.tp_shards == n and eng._spec_enabled
        s0 = eng.stats()
        got = _streams(eng)
        s1 = eng.stats()
        if draft:
            assert eng._draft.shards == n
    finally:
        eng.shutdown()
    assert got == _off_streams(dense_weights, layout)
    assert s1["spec_verify_dispatches"] > s0["spec_verify_dispatches"]
    assert s1["spec_accepted_tokens"] > s0["spec_accepted_tokens"]
    if draft:
        # the target's own weights as the draft: every greedy draft accepted
        assert s1["spec_draft_dispatches"] > s0["spec_draft_dispatches"]


def test_the_runtime_spec_switches_serve_under_tp(dense_weights):
    """``set_spec_decode`` and ``set_spec_proposer`` on a TP=2 engine built
    with spec off: the lookup verify serves, then off again, streams
    equal throughout."""
    eng = LLMEngine(EngineConfig(kv_layout="paged", **COMMON), params=dense_weights, mesh=_mesh(2))
    try:
        assert eng.set_spec_decode(True) is True
        assert eng.set_spec_proposer("lookup") == "lookup"
        s0 = eng.stats()
        on = _streams(eng)
        assert eng.stats()["spec_verify_dispatches"] > s0["spec_verify_dispatches"]
        assert eng.set_spec_decode(False) is False
        off = _streams(eng)
    finally:
        eng.shutdown()
    assert on == off == _off_streams(dense_weights, "paged")


def test_the_draft_runtime_lives_on_the_engine_mesh(dense_weights):
    from generativeaiexamples_tpu.parallel import sharding as jsharding

    eng = LLMEngine(EngineConfig(kv_layout="paged", spec_decode_enable="on",
                                 spec_proposer="draft_model", spec_draft_model="debug-8dev",
                                 spec_draft_kv_dtype="int8", **COMMON),
                    params=dense_weights, draft_params=dense_weights, mesh=_mesh(4))
    try:
        draft = eng._draft
        lp = draft._params["layers"][0]
        assert isinstance(lp["wq"], Shards) and len(lp["wq"]) == 4
        assert tuple(lp["wq"][0].shape) == (CFG.hidden_size, CFG.q_dim // 4)
        assert isinstance(draft._caches[0], Shards)
        # int8 head-major [B, Hkv/N, S, Dh]
        assert draft._caches[0][0]["k"].shape[1] == CFG.num_kv_heads // 4
        assert draft.cache_bytes() == sum(
            t.numel() * t.element_size() for c in draft._caches for p in c for t in p.values())
    finally:
        eng.shutdown()
    # the target's rule, the model axis where JAX's puts it
    for quantized in (False, True):
        port = sharding.draft_kv_cache_specs(quantized)
        want = jsharding.draft_kv_cache_specs(quantized)
        assert port == sharding.kv_cache_layer_specs(quantized)
        assert {k: list(v).index("model") for k, v in want.items()} == port


def test_a_draft_that_does_not_divide_stays_whole(dense_weights):
    """``debug-draft`` has one KV head: at TP=2 it runs whole on the first
    shard's device; the streams are the one-shard engine's."""
    eng = LLMEngine(EngineConfig(kv_layout="paged", spec_decode_enable="on",
                                 spec_proposer="draft_model", spec_draft_model="debug-draft",
                                 **COMMON),
                    params=dense_weights, mesh=_mesh(2))
    try:
        assert eng._draft.shards == 1
        assert not isinstance(eng._draft._caches[0], Shards)
        s0 = eng.stats()
        got = _streams(eng)
        assert eng.stats()["spec_draft_dispatches"] > s0["spec_draft_dispatches"]
    finally:
        eng.shutdown()
    assert got == _off_streams(dense_weights, "paged")


def test_port_tp_spec_matches_the_jax_tp_spec_engine(monkeypatch):
    """The JAX engine at tensor_parallelism=2 with ``spec_decode_enable``
    on (its TP kernels in Pallas interpret mode, set for its build only),
    W8A8 weights and an int8 page pool, against the port at TP=2 on the
    JAX engine's own weights in their per-shard layout: the verify's
    products are exact integer sums and both sides quantize each row
    shard's activations alike, so the streams are token-identical."""
    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu.ops import quant as jquant
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(COMMON, max_batch_size=2, quantization="w8a8", kv_cache_dtype="int8",
                  kv_layout="paged", decode_runahead=1, prefix_cache_enable="off",
                  spec_decode_enable="on")
    monkeypatch.setenv("GENAI_TPU_TP_KERNELS", "interpret")
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=2, serving_layout="layered", **common))
    monkeypatch.delenv("GENAI_TPU_TP_KERNELS")
    tree = jquant.init_packed_params_int8(jl.PRESETS["debug-8dev"], 0, jnp.float32, tp_shards=2)
    port = LLMEngine(EngineConfig(**common), mesh=_mesh(2),
                     params=params_from_jax(jax.tree.map(np.asarray, tree), mesh=_mesh(2)))
    try:
        assert jax_engine._tp is not None and port._tp is not None
        for prompt, sp in LEGS[:2]:
            fields = dict(temperature=sp.temperature, top_p=sp.top_p, max_tokens=16, seed=sp.seed)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**fields), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**fields), timeout=600))
            assert out == ref, prompt
        assert port.stats()["spec_verify_dispatches"] > 0
    finally:
        jax_engine.shutdown()
        port.shutdown()
