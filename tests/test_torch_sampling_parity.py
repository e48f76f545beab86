"""Seeded streams after a monolithic prefill, the JAX engine against the
port's, on the JAX engine's own weights (debug preset, float32, paged,
``prefill_chunk`` 16, page 8, temperature 0.9, seed 7, 4 tokens).

Prompts of 3 and 16 ids take the monolithic prefill, 38 ids the chunked
one. Packed weights give exact ties in the logits, and the nucleus draw
indexes its gumbels by rank inside ``jax.lax.top_k``'s order, which puts
the lower index first among equal values: the port ranks ties the same
way (``sampling.nucleus_top_k``), so its streams are JAX's token for token
on every row with the reference's numerics: no quantization, an int8 KV
pool, and w8a8.

Int8 weight-only rows carry the reference's two int8 numerics: the port's
product scales after the f32 sum (the Pallas kernel's formula), while the
JAX engine on the CPU runs ``int8_matmul_xla``, which rounds the scaled
weight to bf16 before the dot. Their logits differ within ``INT8_TOL``,
and with JAX's product substituted in the port the streams are identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.models import sampling as jsampling
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models import sampling as tsampling
from generativeaiexamples_tpu_torch.models.convert import params_from_jax
from generativeaiexamples_tpu_torch.ops import int8_matmul as im

COMMON = dict(
    model_config_name="debug", dtype="float32", max_batch_size=2, max_seq_len=128,
    prefill_chunk=16, page_size=8, decode_block=4,
)
PROMPTS = [
    [256, 72, 105],
    list(range(40, 56)),
    [256] + [(5 * i) % 250 for i in range(37)],
]
# the reference's two int8 numerics on the debug model: max |logit
# difference| 0.049 for these prompts
INT8_TOL = 0.1


def _engines(quantization, kv_cache_dtype):
    quant = dict(quantization=quantization, kv_cache_dtype=kv_cache_dtype)
    jax_engine = JaxEngine(JaxEngineConfig(
        tensor_parallelism=1, kv_layout="paged", decode_runahead=1, **COMMON, **quant
    ))
    port = LLMEngine(EngineConfig(decode_runahead=1, **COMMON, **quant), device="cpu",
                     params=params_from_jax(jax_engine.params))
    return jax_engine, port


def _streams(jax_engine, port):
    out = []
    for top_p in (0.8, 1.0):
        for prompt in PROMPTS:
            kw = dict(temperature=0.9, top_p=top_p, max_tokens=4, seed=7)
            ref = list(jax_engine.iter_ids(prompt, JaxParams(**kw), timeout=600))
            got = list(port.iter_ids(prompt, SamplingParams(**kw), timeout=600))
            out.append((top_p, len(prompt), ref, got))
    return out


def test_nucleus_ranks_tied_logits_as_jax_top_k():
    """Rows with many exact ties inside the top 64: the same values and
    indices as ``jax.lax.top_k``, and the same sampled tokens."""
    rng = np.random.default_rng(0)
    B, V = 16, 512
    logits = (rng.integers(-6, 7, (B, V)) / 4.0).astype(np.float32)  # 49 distinct values
    vals, idx = jax.lax.top_k(jnp.asarray(logits), 64)
    t_vals, t_idx = tsampling.nucleus_top_k(torch.from_numpy(logits), 64)
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(vals))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    positions = rng.integers(0, 8192, B).astype(np.int32)
    temps = np.full((B,), 0.9, np.float32)
    topps = np.array([0.8, 0.3, 0.95, 1.0] * 4, np.float32)
    keys = jsampling.sample_keys(jax.random.PRNGKey(1234), jnp.asarray(seeds), jnp.asarray(positions))
    ref = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temps),
                                             jnp.asarray(topps)))
    got = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps), torch.from_numpy(topps),
        tsampling.sample_keys(torch.from_numpy(seeds), torch.from_numpy(positions)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_nucleus_orders_signed_zeros_and_masked_logits_as_jax_top_k():
    """XLA's total order at the full llama3 vocabulary (128,256 ids, the
    widest index the key holds): 0.0 above -0.0, -inf last, ties by the
    lower index."""
    rng = np.random.default_rng(1)
    V = 128256
    logits = rng.choice(np.array([1.5, 0.0, -0.0, -1.0, -np.inf], np.float32), (3, V))
    logits[0, -70:] = 2.0  # ties at the highest indices
    logits[1] = -0.0
    logits[1, V - 1] = 0.0
    vals, idx = jax.lax.top_k(jnp.asarray(logits), 64)
    t_vals, t_idx = tsampling.nucleus_top_k(torch.from_numpy(logits), 64)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(np.signbit(t_vals.numpy()), np.signbit(np.asarray(vals)))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(vals))


@pytest.mark.parametrize("quantization,kv_cache_dtype", [
    ("none", "bfloat16"), ("none", "int8"), ("w8a8", "bfloat16"),
], ids=["f32", "f32-int8kv", "w8a8"])
def test_seeded_streams_after_a_monolithic_prefill_match_the_jax_engine(
        quantization, kv_cache_dtype):
    jax_engine, port = _engines(quantization, kv_cache_dtype)
    try:
        for top_p, n, ref, got in _streams(jax_engine, port):
            assert got == ref, (top_p, n)
    finally:
        jax_engine.shutdown()
        port.shutdown()


def _xla_int8_product(x, q, scale):
    """``int8_matmul_xla``: the scaled weight rounded to bf16, then the dot
    in the activation's dtype."""
    K, F = x.shape[-1], scale.shape[-1]
    w = (q[:K, :F].float() * scale.float()).to(torch.bfloat16)
    return x @ w.to(x.dtype)


def test_int8_weight_streams_differ_only_by_the_reference_s_int8_numerics(monkeypatch):
    jax_engine, port = _engines("int8", "int8")
    try:
        cfg = jl.PRESETS["debug"]
        V = jax_engine._sample_vocab
        for prompt in PROMPTS[:2]:
            tok = np.zeros((1, 16), np.int32)
            tok[0, : len(prompt)] = prompt
            lengths = np.array([len(prompt)], np.int32)
            # the JAX engine's monolithic program, jitted as it runs there
            ref = jax.jit(lambda p, t, n: jl.prefill_layers(
                p, cfg, t, n, use_flash=None, quant_kernel=jax_engine._quant_kernel)[0])(
                jax_engine.params, jnp.asarray(tok), jnp.asarray(lengths))
            got, _ = tl.prefill_layers(port.params, tl.PRESETS["debug"], torch.from_numpy(tok).long(),
                                       torch.from_numpy(lengths).long())
            diff = np.abs(got[:, :V].numpy() - np.asarray(ref)[:, :V]).max()
            assert 0 < diff <= INT8_TOL, diff
        monkeypatch.setattr(im, "int8_matmul", _xla_int8_product)
        monkeypatch.setattr(im, "int8_matmul_dequant", _xla_int8_product)
        for top_p, n, ref, got in _streams(jax_engine, port):
            assert got == ref, (top_p, n)
    finally:
        jax_engine.shutdown()
        port.shutdown()
