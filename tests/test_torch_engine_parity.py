"""Engine against engine: the JAX package's LLMEngine and the port's, on the
same debug float32 weights, give the same greedy streams for the same
prompts (short, one chunk, and longer than prefill_chunk), through each
engine's own admission, paged prefill and block decode. Both compute in
float32, so the streams must be identical token for token.

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
    port = LLMEngine(EngineConfig(**COMMON), device="cpu", params=params_from_jax(weights))
    try:
        for prompt in PROMPTS:
            ref = list(jax_engine.iter_ids(prompt, JaxParams(temperature=0.0, max_tokens=16), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(temperature=0.0, max_tokens=16), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()
