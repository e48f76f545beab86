"""The port's engine over a mesh of N ``cpu`` shards (``mesh=``, the
counterpart of the JAX engine on its virtual 8-device mesh): greedy
streams equal to the one-shard engine's on the same weights at TP = 2, 4
and 8, on the paged and the fixed KV layouts with the prefix cache at its
default (``auto``; a repeated prompt's warm stream equals its cold one),
the model functions' logits against TP=1 under int8 and W8A8 packs, the
engine's TP state (unfused per-shard packs, caches of Hkv/N heads, the
page kernel gated on the local tile), and the port's TP=2 stream against
the JAX package's TP=2 engine on the same weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.parallel import create_mesh, sharding, tp_kernels
from generativeaiexamples_tpu_torch.parallel.sharding import Shards

CFG = llama.PRESETS["debug-8dev"]
COMMON = dict(model_config_name="debug-8dev", dtype="float32", max_batch_size=4, max_seq_len=128,
              prefill_chunk=16, page_size=8, decode_block=4)
# one-chunk, two-chunk and three-chunk prompts; the last one again, warm
PROMPTS = [[256, 72, 105, 7], [3 + 7 * j for j in range(20)], [(5 * j) % 250 + 1 for j in range(40)]]
GREEDY = SamplingParams(temperature=0.0, max_tokens=12)


def _mesh(n):
    return create_mesh(n, devices=["cpu"] * n)


def _streams(engine):
    out = [list(engine.iter_ids(p, GREEDY, timeout=120)) for p in PROMPTS]
    out.append(list(engine.iter_ids(PROMPTS[-1], GREEDY, timeout=120)))
    return out


@pytest.fixture(scope="module")
def dense_weights():
    return llama.init_params(CFG, 0, torch.float32)


_REFERENCE = {}


def _reference(dense_weights, layout, kv_dtype):
    key = (layout, kv_dtype)
    if key not in _REFERENCE:
        eng = LLMEngine(EngineConfig(kv_layout=layout, kv_cache_dtype=kv_dtype, **COMMON),
                        device="cpu", params=dense_weights)
        try:
            _REFERENCE[key] = _streams(eng)
        finally:
            eng.shutdown()
    return _REFERENCE[key]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("layout,kv_dtype", [
    ("paged", "bfloat16"), ("paged", "int8"), ("paged", "int4"), ("fixed", "bfloat16"),
    ("fixed", "int8"),
])
def test_tp_streams_equal_one_shard(dense_weights, layout, kv_dtype, n):
    """Same float32 weights at TP=1 and TP=n: the column products are the
    same dot products, the row reduce sums n f32 partials, so logits move
    by ~1e-6 and greedy streams are equal; the prefix cache (auto) serves
    the repeated prompt warm, equal to its cold stream."""
    ref = _reference(dense_weights, layout, kv_dtype)
    eng = LLMEngine(EngineConfig(kv_layout=layout, kv_cache_dtype=kv_dtype, **COMMON),
                    params=dense_weights, mesh=_mesh(n))
    try:
        assert eng.tp_shards == n and eng._paged == (layout == "paged")
        assert eng._prefix is not None
        got = _streams(eng)
        stats = eng.stats()
    finally:
        eng.shutdown()
    assert got == ref
    assert got[-1] == got[-2]
    assert stats["prefix_cache_hits"] >= 1 and stats["tp_shards"] == n


def test_engine_tp_state(dense_weights):
    """Unfused per-shard packs on the shards, caches of Hkv/N heads a
    shard, the page kernel asked about the local tile, the mesh report."""
    params = quant.init_packed_params_int8(CFG, seed=1, dtype=torch.float32)
    eng = LLMEngine(EngineConfig(kv_layout="paged", quantization="int8", **COMMON),
                    params=params, mesh=_mesh(4))
    try:
        lp = eng.params["layers"][0]
        assert "wqkv" not in lp and isinstance(lp["wq"], Shards) and len(lp["wq"]) == 4
        assert tuple(lp["wq"][0]["scale"].shape) == (1, CFG.q_dim // 4)
        assert tuple(lp["wo"][0]["scale"].shape) == (1, CFG.hidden_size)
        assert not isinstance(eng.params["embed"], Shards)
        assert isinstance(eng._cache[0], Shards)
        assert eng._cache[0][0]["k"].shape[2] == CFG.num_kv_heads // 4
        assert isinstance(eng._tp, tp_kernels.TPContext) and eng._tp.shards == 4
        # head_dim 16 is no page-kernel head dim: the gather read, as on one device
        assert not eng._page_kernel
        report = eng.mesh_report()
        assert report["shards"] == 4 and report["peaks"]["devices"] == 1
        assert set(report["memory"]) == {"cpu"} and report["memory"]["cpu"]["planned_bytes"] > 0
        assert len(list(eng.iter_ids(PROMPTS[1], GREEDY, timeout=120))) == 12
    finally:
        eng.shutdown()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_tp_logits_match_one_shard_under_int8_packs(n, mode):
    """The model functions at TP=n against TP=1 on one int8 tree: the only
    difference is the row reduce's rounding of each shard's bf16 partial
    (and under W8A8 each row shard's own activation scale), so the logits
    agree within a few bf16 steps of the activations."""
    dt = torch.float32
    params = quant.init_packed_params_int8(CFG, seed=n, dtype=dt)
    tp = tp_kernels.TPContext(_mesh(n), n)
    sharded = sharding.shard_params(params, tp.mesh, repack_cfg=CFG)
    tokens = torch.tensor([[5, 9, 13, 200, 77, 1], [8, 3, 2, 0, 0, 0]])
    lengths = torch.tensor([6, 3])
    a, kv_a = llama.prefill_layers(params, CFG, tokens, lengths, quant_kernel=mode)
    b, kv_b = llama.prefill_layers(sharded, CFG, tokens, lengths, quant_kernel=mode, tp=tp)
    tables = torch.tensor([[1, 0], [2, 0]], dtype=torch.int32)
    pools_a = llama.init_kv_pool(CFG, 4, 8, dt)
    pools_b = llama.init_kv_pool(CFG, 4, 8, dt, tp=tp)
    llama.write_prefill_pages(pools_a, kv_a, tables, 8)
    llama.write_prefill_pages(pools_b, kv_b, tables, 8, tp=tp)
    live = torch.tensor([True, True])
    da, _ = llama.decode_layers_paged(params, CFG, torch.tensor([4, 6]), lengths, live, tables,
                                      pools_a, page_size=8, quant_kernel=mode)
    db, _ = llama.decode_layers_paged(sharded, CFG, torch.tensor([4, 6]), lengths, live, tables,
                                      pools_b, page_size=8, quant_kernel=mode, tp=tp)
    scale = float(a.abs().max())
    assert float((a - b).abs().max()) < 0.05 * scale
    assert float((da - db).abs().max()) < 0.05 * scale


@pytest.mark.parametrize("layout", ["paged", "fixed"])
def test_one_shard_mesh_is_the_single_device_engine(dense_weights, layout):
    """``mesh=create_mesh(1, ...)`` builds no TP context and streams as
    ``device=`` does."""
    eng = LLMEngine(EngineConfig(kv_layout=layout, **COMMON), params=dense_weights, mesh=_mesh(1))
    try:
        assert eng._tp is None and eng.tp_shards == 1 and not isinstance(eng._cache[0], Shards)
        assert _streams(eng) == _reference(dense_weights, layout, "bfloat16")
    finally:
        eng.shutdown()


def test_port_tp_stream_matches_the_jax_tp_engine(monkeypatch):
    """The JAX engine at tensor_parallelism=2 on its virtual mesh, its TP
    kernels in Pallas interpret mode (``GENAI_TPU_TP_KERNELS=interpret``,
    set for the JAX side only; its pool read is the gathered window, as the
    port's on head_dim 16), W8A8 weights and an int8 page pool, against
    the port at TP=2 on the JAX engine's own weights carried across in
    their per-shard layout. W8A8's products are exact integer sums and
    both sides quantize each row shard's activations alike; two shards'
    f32 partials add alike in any order."""
    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu.ops import quant as jquant
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(COMMON, max_batch_size=2, quantization="w8a8", kv_cache_dtype="int8",
                  kv_layout="paged", decode_runahead=1, prefix_cache_enable="off")
    monkeypatch.setenv("GENAI_TPU_TP_KERNELS", "interpret")
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=2, serving_layout="layered", **common))
    monkeypatch.delenv("GENAI_TPU_TP_KERNELS")
    # the JAX engine's no-checkpoint weights, drawn in its per-shard layout
    tree = jquant.init_packed_params_int8(jl.PRESETS["debug-8dev"], 0, jnp.float32, tp_shards=2)
    port = LLMEngine(EngineConfig(**common), mesh=_mesh(2),
                     params=params_from_jax(jax.tree.map(np.asarray, tree), mesh=_mesh(2)))
    try:
        assert jax_engine._tp is not None and port._tp is not None
        for prompt in PROMPTS[:2]:
            ref = list(jax_engine.iter_ids(prompt, JaxParams(temperature=0.0, max_tokens=8), timeout=600))
            out = list(port.iter_ids(prompt, SamplingParams(temperature=0.0, max_tokens=8), timeout=600))
            assert out == ref, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()
