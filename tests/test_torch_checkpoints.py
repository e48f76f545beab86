"""Checkpoints into the port: its safetensors reader and writer
(utils/safetensors_io.py) against the ``safetensors`` package, and its HF
loader (models/hf_loader.py), ``load_bert_params`` and the engine built
from ``checkpoint_path`` against the JAX package's, on the CPU at the
``debug`` preset, on checkpoints written by either package.

Tolerances. Loading is a copy, a transpose and a dtype cast, so the
port's tensors equal JAX's bit for bit (bf16 by round-to-nearest-even on
both sides), and the streamed int8 and W8A8 packs byte for byte (the same
f32 max, division and round-half-even on both sides), at one shard and
at two. Engine streams: dense f32 weights give both engines the same f32
math in another summation order (logits within ~1e-5), so greedy streams
are equal; an engine from a checkpoint and one given the same packs in
memory run the same code and are equal.
"""
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import save_file as torch_save_file

from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu.models import hf_loader as jhf
from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.models import hf_loader as thf
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.convert import to_tensor
from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.parallel import create_mesh, sharding
from generativeaiexamples_tpu_torch.parallel.sharding import Shards
from generativeaiexamples_tpu_torch.utils import safetensors_io as st

CFG_J = jl.PRESETS["debug"]
CFG_T = tl.PRESETS["debug"]


def _np(x):
    return np.asarray(jax.device_get(x))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, for byte-for-byte comparisons."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _same_bytes(a, b) -> bool:
    a = a if isinstance(a, torch.Tensor) else to_tensor(_np(a))
    b = b if isinstance(b, torch.Tensor) else to_tensor(_np(b))
    return a.dtype == b.dtype and tuple(a.shape) == tuple(b.shape) and \
        np.array_equal(_bits(a), _bits(b))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package (f32, 2 files)."""
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    jhf.write_hf_checkpoint(CFG_J, path, seed=0, n_shards=2)
    return path


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A checkpoint written by the port (f32, 2 files)."""
    path = str(tmp_path_factory.mktemp("port_ckpt"))
    thf.write_hf_checkpoint(CFG_T, path, seed=1, n_shards=2)
    return path


# --------------------------------------------------------------------- #
# the safetensors format


def test_reader_reads_safetensors_numpy_files(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i8": rng.integers(-128, 127, (4, 4)).astype(np.int8),
        "i32": rng.integers(-2**31, 2**31 - 1, (6,)).astype(np.int32),
        "i64": np.arange(12, dtype=np.int64).reshape(3, 4),
        "scalar": np.array(2.5, np.float32),
    }
    path = str(tmp_path / "a.safetensors")
    np_save_file(tensors, path, metadata={"format": "np"})
    f = st.SafeTensorsFile(path)
    assert sorted(f.keys()) == sorted(tensors) and f.metadata() == {"format": "np"}
    for name, want in tensors.items():
        got = f.get_tensor(name)
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), name


def test_reader_reads_bf16_bit_exact_from_safetensors_torch(tmp_path):
    tensors = {"bf16": torch.randn(5, 9).to(torch.bfloat16), "f32": torch.randn(4)}
    path = str(tmp_path / "b.safetensors")
    torch_save_file(tensors, path)
    got = dict(st.iter_tensors(path))
    assert got["bf16"].dtype == torch.bfloat16
    assert _same_bytes(got["bf16"], tensors["bf16"]) and _same_bytes(got["f32"], tensors["f32"])


def test_writer_is_read_by_safe_open_tensor_for_tensor(tmp_path):
    tensors = {
        "w.bf16": torch.randn(8, 3).to(torch.bfloat16),
        "w.f16": torch.randn(2, 2).to(torch.float16),
        "w.f32": torch.randn(5),
        "w.i8": torch.randint(-127, 127, (3, 3), dtype=torch.int8),
        "w.i32": torch.randint(0, 100, (4,), dtype=torch.int32),
        "w.i64": torch.arange(6, dtype=torch.int64),
        "w.t": torch.randn(4, 6).T,  # a non-contiguous view is written in its logical order
    }
    path = str(tmp_path / "c.safetensors")
    st.save_file(tensors, path, metadata={"k": "v"})
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors) and f.metadata() == {"k": "v"}
        for name, want in tensors.items():
            assert _same_bytes(f.get_tensor(name), want.contiguous()), name
    assert np.array_equal(np_load_file(path)["w.i64"], np.arange(6))


def _write_raw(path, header: dict, data: bytes):
    raw = json.dumps(header).encode()
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["truncated", "overlap", "hole", "past_end", "shape", "not_json",
                                  "short_header", "dtype"])
def test_reader_refuses_a_bad_file_naming_it(tmp_path, case):
    path = str(tmp_path / f"{case}.safetensors")
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "truncated":
        st.save_file({"x": torch.randn(16), "y": torch.randn(3)}, path)
        with open(path, "rb") as fh:
            raw = fh.read()
        with open(path, "wb") as fh:
            fh.write(raw[:-5])
    elif case == "overlap":
        _write_raw(path, {"a": a, "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, b"\0" * 12)
    elif case == "hole":
        _write_raw(path, {"a": a, "b": {"dtype": "F32", "shape": [1], "data_offsets": [12, 16]}}, b"\0" * 16)
    elif case == "past_end":
        _write_raw(path, {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8)
    elif case == "shape":
        _write_raw(path, {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8)
    elif case == "dtype":
        _write_raw(path, {"a": {"dtype": "Q7", "shape": [2], "data_offsets": [0, 8]}}, b"\0" * 8)
    elif case == "not_json":
        with open(path, "wb") as fh:
            fh.write(struct.pack("<Q", 4) + b"{no}")
    else:
        with open(path, "wb") as fh:
            fh.write(b"\x05\x00")
    with pytest.raises(ValueError, match=str(tmp_path)):
        st.SafeTensorsFile(path)


# --------------------------------------------------------------------- #
# the HF loader


def test_config_from_hf_is_jax_s_field_for_field(tmp_path, jax_ckpt, port_ckpt):
    for path in (jax_ckpt, port_ckpt):
        assert thf.config_from_hf(path).__dict__ == jhf.config_from_hf(path).__dict__
    assert thf.config_from_hf(port_ckpt) == CFG_T
    sparse = tmp_path / "sparse"
    sparse.mkdir()
    (sparse / "config.json").write_text(json.dumps(
        {"vocab_size": 300, "hidden_size": 96, "intermediate_size": 160,
         "num_hidden_layers": 3, "num_attention_heads": 6}))
    assert thf.config_from_hf(str(sparse)).__dict__ == jhf.config_from_hf(str(sparse)).__dict__
    assert thf.config_from_hf(str(tmp_path)) is None is jhf.config_from_hf(str(tmp_path))


@pytest.mark.parametrize("jdt, tdt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_params_is_jax_s_bit_for_bit(jax_ckpt, port_ckpt, writer, jdt, tdt):
    path = jax_ckpt if writer == "jax" else port_ckpt
    want = jhf.load_params(path, CFG_J, jdt)
    got = thf.load_params(path, CFG_T, tdt)
    for key in ("embed", "final_norm", "lm_head"):
        assert _same_bytes(got[key], want[key]), key
    assert len(got["layers"]) == CFG_T.num_layers
    for i, lp in enumerate(got["layers"]):
        assert set(lp) == set(want["layers"])
        for key, val in lp.items():
            assert val.is_contiguous() and _same_bytes(val, want["layers"][key][i]), (i, key)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("quantization", ["int8", "w8a8"])
def test_streamed_packs_are_jax_s_byte_for_byte(jax_ckpt, quantization, tp):
    """Packs at one shard (fused wqkv/w_gateup) and at two (unfused
    per-shard layout), and the same peak host bytes."""
    jstats, tstats = {}, {}
    want = jhf.load_params_layered_streaming(jax_ckpt, CFG_J, jnp.bfloat16, quantization=quantization,
                                             tp_shards=tp, stats=jstats)
    got = thf.load_params_layered_streaming(jax_ckpt, CFG_T, torch.bfloat16, quantization=quantization,
                                            tp_shards=tp, stats=tstats)
    assert tstats["peak_host_bytes"] == jstats["peak_host_bytes"] > 0
    for key in ("embed", "final_norm"):
        assert _same_bytes(got[key], want[key]), key
    for k in ("q", "scale"):
        assert _same_bytes(got["lm_head"][k], want["lm_head"][k])
    for lp, jp in zip(got["layers"], want["layers"]):
        assert set(lp) == set(jp)
        assert ("wqkv" in lp) == (tp == 1)
        for key, val in lp.items():
            if isinstance(val, dict):
                assert _same_bytes(val["q"], jp[key]["q"]) and _same_bytes(val["scale"], jp[key]["scale"]), key
            else:
                assert _same_bytes(val, jp[key]), key


@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_streamed_load_on_a_mesh_is_the_single_device_tree_cut(port_ckpt, quantization):
    """On a mesh of two shards the streamed tree is ``shard_params`` of
    the single-device tree, every piece byte for byte."""
    mesh = create_mesh(2, devices=["cpu", "cpu"])
    q8 = quantization != "none"
    single = thf.load_params_layered_streaming(port_ckpt, CFG_T, torch.float32, quantization=quantization)
    cut = sharding.shard_params(single, mesh, repack_cfg=CFG_T)
    got = thf.load_params_layered_streaming(port_ckpt, CFG_T, torch.float32, quantization=quantization,
                                            mesh=mesh, tp_shards=2 if q8 else 1)
    assert sharding.is_sharded(got)

    def same(a, b):
        if isinstance(a, Shards):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        return _same_bytes(a, b)

    assert same(got["lm_head"], cut["lm_head"]) and same(got["embed"], cut["embed"])
    assert all(same(a, b) for a, b in zip(got["layers"], cut["layers"]))


def test_an_incomplete_checkpoint_raises_as_jax(tmp_path, port_ckpt):
    path = tmp_path / "incomplete"
    path.mkdir()
    files = sorted(f for f in os.listdir(port_ckpt) if f.endswith(".safetensors"))
    for name in files:
        tensors = np_load_file(os.path.join(port_ckpt, name))
        tensors.pop("model.layers.1.mlp.up_proj.weight", None)
        np_save_file(tensors, str(path / name))
    with pytest.raises(ValueError, match="Checkpoint incomplete") as want:
        for _ in jhf.iter_param_groups(str(path), CFG_J):
            pass
    with pytest.raises(ValueError, match="Checkpoint incomplete") as got:
        thf.load_params_layered_streaming(str(path), CFG_T, torch.float32, quantization="int8")
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        thf.load_params(str(tmp_path / "empty_dir_missing"), CFG_T)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="No .safetensors files"):
        thf.load_params(str(tmp_path / "empty"), CFG_T)


def test_a_missing_lm_head_ties_with_jax_s_warning(tmp_path, port_ckpt, caplog):
    path = tmp_path / "nohead"
    path.mkdir()
    for name in os.listdir(port_ckpt):
        src = os.path.join(port_ckpt, name)
        if name.endswith(".safetensors"):
            tensors = np_load_file(src)
            tensors.pop("lm_head.weight", None)
            np_save_file(tensors, str(path / name))
        else:
            (path / name).write_bytes(open(src, "rb").read())
    with caplog.at_level("WARNING"):
        got = thf.load_params_layered_streaming(str(path), CFG_T, torch.float32, quantization="int8")
    assert "lm_head" not in got
    assert "No lm_head in checkpoint; tying to embeddings." in caplog.text
    tokens = torch.tensor([[3, 9, 27]])
    pos = torch.arange(3)[None]
    logits = tl.forward(got, CFG_T, tokens, pos)
    h_ref = tl.forward({**got, "lm_head": got["embed"].T.contiguous()}, CFG_T, tokens, pos)
    assert torch.equal(logits, h_ref)


@pytest.mark.parametrize("tdt, jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_load_bert_params_is_jax_s(tmp_path, tdt, jdt):
    cfg = tbert.BERT_PRESETS["debug"]
    params = tbert.init_bert_params(cfg, torch.Generator().manual_seed(3), torch.float32)
    # JAX's key map reads both the "bert." names and the bare ones
    tensors = {(k if i % 2 else k[len("bert."):]): v for i, (k, v) in enumerate(tbert.hf_tensors(params).items())}
    st.save_file(tensors, str(tmp_path / "model.safetensors"))
    want = jbert.load_bert_params(str(tmp_path), jbert.BERT_PRESETS["debug"], jdt)
    got = tbert.load_bert_params(str(tmp_path), cfg, tdt)
    for key, val in got.items():
        if key != "layers":
            assert _same_bytes(val, want[key]), key
    assert set(got["layers"][0]) == set(want["layers"])
    for i, lp in enumerate(got["layers"]):
        for key, val in lp.items():
            assert _same_bytes(val, want["layers"][key][i]), (i, key)


# --------------------------------------------------------------------- #
# the engine from checkpoint_path

COMMON = dict(dtype="float32", max_batch_size=2, max_seq_len=128, prefill_chunk=16, page_size=8,
              decode_block=2, kv_layout="paged", prefix_cache_enable="off", decode_runahead=1)
PROMPTS = [[256, 72, 105, 7], [3 + 7 * j for j in range(20)]]


def _greedy(engine, prompts=PROMPTS, n=8, params_cls=SamplingParams):
    return [list(engine.iter_ids(p, params_cls(temperature=0.0, max_tokens=n), timeout=300))
            for p in prompts]


def test_engine_from_checkpoint_streams_as_the_jax_engine(jax_ckpt):
    """The model (config.json), the tokenizer (bytes: no tokenizer.json)
    and the weights all come from the directory on both sides."""
    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams

    # the preset name is not what is served: config.json is
    jax_engine = JaxEngine(JaxEngineConfig(checkpoint_path=jax_ckpt, model_config_name="llama3-8b",
                                           serving_layout="layered", tensor_parallelism=1, **COMMON))
    port = LLMEngine(EngineConfig(checkpoint_path=jax_ckpt, model_config_name="llama3-8b", **COMMON),
                     device="cpu")
    try:
        assert port.model_config.__dict__ == jax_engine.model_config.__dict__
        assert port.load_stats["peak_host_bytes"] > 0
        assert _greedy(port) == _greedy(jax_engine, params_cls=JaxParams)
    finally:
        jax_engine.shutdown()
        port.shutdown()


@pytest.mark.parametrize("quantization", ["int8", "w8a8"])
def test_engine_from_checkpoint_equals_the_engine_given_its_packs(port_ckpt, quantization):
    """The streamed packs are ``quantize_params_int8`` of ``load_params``
    byte for byte (quantized from the file's f32 values, the rest cast to
    bf16), and the two engines stream alike."""
    cfg = dict(COMMON, dtype="bfloat16", quantization=quantization)
    ref_params = quant.quantize_params_int8(thf.load_params(port_ckpt, CFG_T, torch.float32))
    ref_params = {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v
                  for k, v in ref_params.items()}
    ref_params["layers"] = [{k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v
                             for k, v in lp.items()} for lp in ref_params["layers"]]
    served = LLMEngine(EngineConfig(checkpoint_path=port_ckpt, **cfg), device="cpu")
    given = LLMEngine(EngineConfig(model_config_name="debug", **cfg), device="cpu", params=ref_params)
    try:
        for lp, rp in zip(served.params["layers"], ref_params["layers"]):
            assert set(lp) == set(rp)
            for key, val in lp.items():
                if isinstance(val, dict):
                    assert all(_same_bytes(val[k], rp[key][k]) for k in ("q", "scale")), key
                else:
                    assert _same_bytes(val, rp[key]), key
        assert _greedy(served) == _greedy(given)
    finally:
        served.shutdown()
        given.shutdown()


def test_engine_from_checkpoint_at_tp2_streams_as_tp1(port_ckpt):
    """Two ``cpu`` shards from the checkpoint: per-shard packs cut as
    ``shard_params`` cuts the single-device ones, streams equal TP=1's on
    dense f32 weights."""
    mesh = create_mesh(2, devices=["cpu", "cpu"])
    tp2 = LLMEngine(EngineConfig(checkpoint_path=port_ckpt, tensor_parallelism=2, **COMMON), mesh=mesh)
    tp1 = LLMEngine(EngineConfig(checkpoint_path=port_ckpt, **COMMON), device="cpu")
    try:
        assert tp2.tp_shards == 2 and sharding.is_sharded(tp2.params)
        assert _greedy(tp2) == _greedy(tp1)
    finally:
        tp2.shutdown()
        tp1.shutdown()


def test_engine_memory_plan_counts_the_checkpoint_s_model(port_ckpt):
    eng = LLMEngine(EngineConfig(checkpoint_path=port_ckpt, model_config_name="llama3-70b", **COMMON),
                    device="cpu")
    try:
        assert eng.model_config == CFG_T
        embed = CFG_T.vocab_size * CFG_T.hidden_size
        assert 0 < eng.memory_plan["cpu"] < 4 * (tl.count_logical_params(CFG_T) + embed) + 4 * 10**6
    finally:
        eng.shutdown()
