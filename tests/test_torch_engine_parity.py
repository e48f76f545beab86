"""Engine against engine: the JAX package's LLMEngine and the port's, on the
same debug float32 weights, give the same streams for the same prompts
(short, one chunk, and longer than prefill_chunk), through each engine's
own admission, prefill and block decode on the paged and on the fixed KV
layout: greedy, seeded sampling (the port draws with JAX's threefry keys),
and the w8a8 + int8 KV recipe (the weights the JAX engine drew, carried
over). Both compute in float32,
and w8a8's products are exact integer sums, so the streams must be
identical token for token. Each case runs with one decode block in flight
(``decode_runahead=1``) and again with four on both engines.

Slow tier: it builds and compiles a JAX engine."""
import jax.numpy as jnp
import pytest

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models.convert import params_from_jax

pytestmark = pytest.mark.slow

COMMON = dict(
    model_config_name="debug", dtype="float32", max_batch_size=2, max_seq_len=128,
    prefill_chunk=16, page_size=8, decode_block=4,
)
PROMPTS = [
    [256, 72, 105],
    list(range(40, 56)),
    [256] + [(5 * i) % 250 for i in range(37)],
]


def test_greedy_streams_match_the_jax_engine():
    jax_engine = JaxEngine(JaxEngineConfig(
        tensor_parallelism=1, kv_layout="paged", decode_runahead=1, **COMMON
    ))
    # the JAX engine's no-checkpoint weights: init_params_fast(cfg, 0, dtype)
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(decode_runahead=1, **COMMON), device="cpu", params=params_from_jax(weights))
    try:
        for prompt in PROMPTS:
            ref = list(jax_engine.iter_ids(prompt, JaxParams(temperature=0.0, max_tokens=16), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(temperature=0.0, max_tokens=16), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()


@pytest.mark.parametrize("top_p", [0.8, 1.0], ids=["nucleus", "full-vocab"])
def test_seeded_streams_match_the_jax_engine(top_p):
    jax_engine = JaxEngine(JaxEngineConfig(
        tensor_parallelism=1, kv_layout="paged", decode_runahead=1, **COMMON
    ))
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(decode_runahead=1, **COMMON), device="cpu", params=params_from_jax(weights))
    try:
        for i, prompt in enumerate(PROMPTS):
            kw = dict(temperature=0.9, top_p=top_p, max_tokens=16, seed=100 + i)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**kw), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**kw), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()


def test_w8a8_int8_kv_streams_match_the_jax_engine():
    quant = dict(quantization="w8a8", kv_cache_dtype="int8")
    jax_engine = JaxEngine(JaxEngineConfig(
        tensor_parallelism=1, kv_layout="paged", decode_runahead=1, **COMMON, **quant
    ))
    port = LLMEngine(
        EngineConfig(decode_runahead=1, **COMMON, **quant), device="cpu",
        params=params_from_jax(jax_engine.params),
    )
    try:
        for prompt in PROMPTS:
            ref = list(jax_engine.iter_ids(prompt, JaxParams(temperature=0.0, max_tokens=16), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(temperature=0.0, max_tokens=16), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()


@pytest.mark.parametrize("recipe", ["greedy", "seeded", "w8a8-int8"])
def test_fixed_layout_streams_match_the_jax_engine(recipe):
    """Both engines on kv_layout='fixed' (one dense strip per slot): the
    monolithic slot write, the chunked extend over the strips and the fixed
    decode block, greedy, seeded, and w8a8 weights over an int8 head-major
    cache (both sides read it through the non-kernel dequantized read on
    the CPU)."""
    quant = dict(quantization="w8a8", kv_cache_dtype="int8") if recipe == "w8a8-int8" else {}
    jax_engine = JaxEngine(JaxEngineConfig(
        tensor_parallelism=1, kv_layout="fixed", decode_runahead=1, **COMMON, **quant
    ))
    weights = jax_engine.params if quant else jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(
        EngineConfig(kv_layout="fixed", decode_runahead=1, **COMMON, **quant), device="cpu",
        params=params_from_jax(weights),
    )
    try:
        assert not port._paged
        for i, prompt in enumerate(PROMPTS):
            kw = dict(temperature=0.0, max_tokens=16)
            if recipe == "seeded":
                kw = dict(temperature=0.9, top_p=0.8, max_tokens=16, seed=200 + i)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**kw), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**kw), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()


@pytest.mark.parametrize("layout", ["paged", "fixed"])
@pytest.mark.parametrize("recipe", ["greedy", "seeded", "w8a8-int8"])
def test_streams_match_the_jax_engine_at_runahead_4(layout, recipe):
    """The cases above with four decode blocks in flight on both engines:
    each engine's reader emits from slabs dispatched ahead of it, and each
    frees budget-exhausted slots from its host shadows."""
    quant = dict(quantization="w8a8", kv_cache_dtype="int8") if recipe == "w8a8-int8" else {}
    jax_engine = JaxEngine(JaxEngineConfig(
        tensor_parallelism=1, kv_layout=layout, decode_runahead=4, **COMMON, **quant
    ))
    weights = jax_engine.params if quant else jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(
        EngineConfig(kv_layout=layout, decode_runahead=4, **COMMON, **quant), device="cpu",
        params=params_from_jax(weights),
    )
    try:
        assert port._paged == (layout == "paged")
        for i, prompt in enumerate(PROMPTS):
            kw = dict(temperature=0.0, max_tokens=16)
            if recipe == "seeded":
                kw = dict(temperature=0.9, top_p=0.8, max_tokens=16, seed=300 + i)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**kw), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(**kw), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()
