"""The port's engine on the fixed KV layout, on the CPU (every kernel wrapper
runs its plain version): ``kv_layout`` resolution as in the JAX engine
(``auto`` serves a page-misaligned config on the fixed layout instead of
refusing it, an explicit ``paged`` refuses it), fixed-engine streams
token-identical to the paged engine's (greedy and seeded, bf16-family and
int8 KV), the int4 and kernel refusals, and the environment
name."""
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_pages
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams

CONFIG = dict(
    model_config_name="debug", dtype="float32", max_batch_size=3, max_seq_len=128,
    prefill_chunk=16, page_size=8, decode_block=4,
)
PROMPTS = [
    [256, 5, 6, 7],  # short: monolithic wave
    list(range(30, 46)),  # exactly one chunk
    [256] + [(3 * i) % 250 for i in range(40)],  # longer than prefill_chunk: chunked
]


def _drain(q, timeout=120):
    out = []
    while (tok := q.get(timeout=timeout)) is not None:
        out.append(tok)
    return out


def _streams(eng, params):
    """One batch of the three prompts."""
    return [_drain(q) for q in [eng.generate_ids(p, params) for p in PROMPTS]]


def _engine(**overrides):
    return LLMEngine(EngineConfig(**dict(CONFIG, **overrides)), device="cpu")


def test_auto_serves_a_page_misaligned_config_on_the_fixed_layout(caplog):
    """prefill_chunk 12 is no multiple of page_size 8: JAX's auto resolves
    to fixed and logs why; so does the port, and it serves."""
    cfg = EngineConfig(**dict(CONFIG, prefill_chunk=12))
    cfg.validate()
    assert kv_pages.auto_layout_blockers(cfg, 128) == [
        "prefill_chunk 12 is not a multiple of page_size 8"
    ]
    with caplog.at_level("INFO"):
        eng = LLMEngine(cfg, device="cpu")
    try:
        assert not eng._paged and eng._kv_alloc is None
        assert "kv_layout='auto' resolved to 'fixed'" in caplog.text
        assert tuple(eng._cache[0]["k"].shape) == (3, 128, 2, 16)  # [B, S, Hkv, Dh]
        streams = _streams(eng, SamplingParams(temperature=0.0, max_tokens=8))
        assert all(0 < len(s) <= 8 for s in streams)
        assert eng.stats()["prefill_chunks"] >= 4  # the 41-token prompt ran chunked
        assert "pages_in_use" not in eng.stats()
    finally:
        assert eng.shutdown()


def test_explicit_paged_refuses_a_page_misaligned_config():
    with pytest.raises(ValueError, match="multiple of page_size"):
        EngineConfig(**dict(CONFIG, prefill_chunk=12, kv_layout="paged")).validate()
    with pytest.raises(ValueError, match="multiple of page_size"):
        _engine(prefill_chunk=12, kv_layout="paged")


@pytest.mark.parametrize(
    "override,blocker",
    [
        (dict(page_size=12), "page_size 12 is not a power of two <= 128"),
        (dict(page_size=256), "page_size 256 is not a power of two <= 128"),
        (dict(max_seq_len=100), "effective max_seq_len 100 is not a multiple of page_size 8"),
        ({}, None),
    ],
)
def test_auto_layout_blockers(override, blocker):
    cfg = EngineConfig(**dict(CONFIG, **override))
    blockers = kv_pages.auto_layout_blockers(cfg, min(cfg.max_seq_len, 128))
    assert blockers == ([] if blocker is None else [blocker])


@pytest.mark.parametrize("kv_cache_dtype", ["bfloat16", "int8"])
def test_fixed_streams_equal_the_paged_engines(kv_cache_dtype):
    """Greedy and seeded streams, token for token, of a fixed and a paged
    engine on the same weights (the JAX package promises identity across
    layouts, schema.py kv_layout). ``bfloat16`` names the unquantized cache,
    here in the engine's float32."""
    fixed = _engine(kv_layout="fixed", kv_cache_dtype=kv_cache_dtype)
    paged = _engine(kv_layout="paged", kv_cache_dtype=kv_cache_dtype)
    try:
        assert not fixed._paged and paged._paged
        if kv_cache_dtype == "int8":
            c = fixed._cache[0]
            assert c["k"].dtype == torch.int8 and tuple(c["k"].shape) == (3, 2, 128, 16)
            assert tuple(c["ks"].shape) == (3, 2, 1, 128)
        for params in (
            SamplingParams(temperature=0.0, max_tokens=12),
            SamplingParams(temperature=0.9, top_p=0.8, max_tokens=12, seed=11),
            SamplingParams(temperature=0.9, top_p=1.0, max_tokens=12, seed=12),
        ):
            assert _streams(fixed, params) == _streams(paged, params), params
    finally:
        assert fixed.shutdown() and paged.shutdown()


def test_w8a8_int8_fixed_streams_equal_the_paged_engines():
    quant = dict(quantization="w8a8", kv_cache_dtype="int8")
    fixed = _engine(kv_layout="fixed", **quant)
    paged = _engine(kv_layout="paged", **quant)
    try:
        params = SamplingParams(temperature=0.0, max_tokens=10)
        assert _streams(fixed, params) == _streams(paged, params)
    finally:
        assert fixed.shutdown() and paged.shutdown()


def test_decode_window_rules():
    """Full capacity when a kernel reads each slot's own length; otherwise
    the power-of-two rung of max_pos + block."""
    eng = _engine(kv_layout="fixed")
    try:
        assert not eng._kv_kernel
        assert eng._decode_window(100) == 128 and eng._decode_window(60) == 128
        assert eng._decode_window(10) == 128  # the rungs start at 128
        eng._kv_kernel = True
        assert eng._decode_window(0) == eng.max_seq_len
    finally:
        assert eng.shutdown()
    big = _engine(kv_layout="fixed", model_config_name="debug-1k", max_seq_len=1024)
    try:
        assert big._decode_window(200) == 256
        assert big._decode_window(253) == 512  # 253 + block 4 > 256
    finally:
        assert big.shutdown()


@pytest.mark.parametrize("layout", ["fixed", "auto"])
def test_int4_needs_the_paged_layout(layout):
    """JAX refuses int4 on the fixed layout, explicit or resolved by auto."""
    override = dict(kv_cache_dtype="int4", kv_layout=layout)
    if layout == "auto":
        override["prefill_chunk"] = 12  # page-misaligned: auto resolves to fixed
    with pytest.raises(ValueError, match="requires the paged KV layout"):
        _engine(**override)


def test_kernel_check_refuses_an_int8_fixed_cache_the_kernel_does_not_serve():
    """On the card every int8 fixed cache is read by the decode-attention
    kernel; a geometry it refuses (the debug preset's head_dim 16) is an
    error at engine build, never a fall back to the plain read."""
    eng = _engine(kv_layout="fixed", kv_cache_dtype="int8")
    try:
        assert not eng._kv_kernel
        with pytest.raises(ValueError, match="decode attention kernel refuses"):
            eng._check_kernels(eng.engine_config, eng.model_config, torch.bfloat16)
    finally:
        assert eng.shutdown()
    served = _engine(kv_layout="fixed", kv_cache_dtype="int8", model_config_name="kernel-8dev",
                     max_seq_len=256, dtype="bfloat16")
    try:
        assert served._kv_kernel and not served._page_kernel
        served._check_kernels(served.engine_config, served.model_config, torch.bfloat16)
        assert served._decode_window(3) == 256
    finally:
        assert served.shutdown()


def test_kernel_engine_on_cpu_serves_through_the_plain_kernel_function():
    """An int8 fixed cache the kernel serves reads through decode_attention
    (its plain version on the CPU) and streams like the non-kernel read."""
    kw = dict(kv_layout="fixed", kv_cache_dtype="int8", model_config_name="kernel-8dev",
              max_seq_len=256)
    eng = _engine(**kw)
    try:
        assert eng._kv_kernel
        out = _streams(eng, SamplingParams(temperature=0.0, max_tokens=6))
        assert all(0 < len(s) <= 6 for s in out)
        assert all(0 <= t < 512 for s in out for t in s)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("value", ["fixed", "paged", "auto"])
def test_from_env_reads_the_kv_layout(value):
    cfg = EngineConfig.from_env({"APP_ENGINE_KVLAYOUT": value, "APP_ENGINE_PAGESIZE": "16"})
    assert cfg.kv_layout == value and cfg.page_size == 16
    assert EngineConfig.env_name("kv_layout") == "APP_ENGINE_KVLAYOUT"
    cfg.validate()


def test_config_refuses_an_unknown_kv_layout():
    with pytest.raises(ValueError, match="kv_layout"):
        EngineConfig(**dict(CONFIG, kv_layout="ring")).validate()
    assert EngineConfig().kv_layout == "auto"  # the JAX default


def test_fixed_engine_frees_slots_and_keeps_serving():
    eng = _engine(kv_layout="fixed", max_batch_size=2)
    try:
        params = SamplingParams(temperature=0.0, max_tokens=5)
        first = [_drain(q) for q in [eng.generate_ids(p, params) for p in PROMPTS * 2]]
        again = [_drain(q) for q in [eng.generate_ids(p, params) for p in PROMPTS]]
        assert first[:3] == again and first[3:] == again
        assert np.all([len(s) <= 5 for s in first])
    finally:
        assert eng.shutdown()
