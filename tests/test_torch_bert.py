"""The port's BERT encoder (generativeaiexamples_tpu_torch/models/bert.py)
against the JAX package's (generativeaiexamples_tpu/models/bert.py) on the
same weights, carried across by ``convert.bert_params_from_numpy``.

Tolerances, on unit-norm embeddings (and raw logits of about 1):
- float32: max |Δ| <= 1e-6 (both sum in f32, in other orders);
- bfloat16, CLS pooling and cross-encoder logits: max |Δ| <= 1e-5 (JAX
  run op by op rounds where the port rounds; observed ~3e-8, the f32 tail
  of the normalization);
- bfloat16, mean pooling: max |Δ| <= 1e-3 (the masked sum over positions
  runs in bf16, accumulated in another order: one bf16 step of a summand
  is ~4e-3 of its value).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import bert as jbert
from generativeaiexamples_tpu_torch.models import bert as tbert
from generativeaiexamples_tpu_torch.models.convert import bert_params_from_numpy, rank_head_from_numpy

# the debug preset, and a small config that is not it
CONFIGS = {
    "debug": jbert.BERT_PRESETS["debug"],
    "small": jbert.BertConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                              num_layers=2, num_heads=4, max_positions=256),
}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tcfg(cfg):
    return tbert.BertConfig(**dataclasses.asdict(cfg))


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(seed, B=3, T=40, lengths=(40, 17, 5), vocab=512):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    mask = np.zeros((B, T), np.int32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
    types = np.repeat((np.arange(T)[None, :] > 10).astype(np.int32), B, axis=0)
    return ids, mask, types


def _tol(dtype, pooling):
    if dtype == "float32":
        return 1e-6
    return 1e-5 if pooling == "cls" else 1e-3


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("with_types", [False, True], ids=["no_types", "types"])
def test_bert_encode_matches_jax(config, dtype, pooling, with_types):
    cfg = dataclasses.replace(CONFIGS[config], pooling=pooling)
    params = jbert.init_bert_params(cfg, jax.random.PRNGKey(0), dtype=DTYPES[dtype])
    ids, mask, types = _inputs(1)
    want = np.asarray(jbert.bert_encode(params, cfg, ids, mask, types if with_types else None))
    got = tbert.bert_encode(
        bert_params_from_numpy(_tree(params)), _tcfg(cfg), torch.from_numpy(ids),
        torch.from_numpy(mask), torch.from_numpy(types) if with_types else None,
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= _tol(dtype, pooling)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cross_encode_score_matches_jax(config, dtype):
    cfg = CONFIGS[config]
    key = jax.random.PRNGKey(3)
    params = jbert.init_bert_params(cfg, key, dtype=DTYPES[dtype])
    head = jbert.init_rank_head(cfg, jax.random.fold_in(key, 1), dtype=DTYPES[dtype])
    ids, mask, types = _inputs(2)
    want = np.asarray(jbert.cross_encode_score(params, head, cfg, ids, mask, types))
    got = tbert.cross_encode_score(
        bert_params_from_numpy(_tree(params)), rank_head_from_numpy(_tree(head)), _tcfg(cfg),
        torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types),
    )
    assert tuple(got.shape) == (3,)
    assert np.abs(got.numpy() - want).max() <= (1e-6 if dtype == "float32" else 1e-5)


def _port_params(cfg, dtype=torch.bfloat16, seed=0):
    return tbert.init_bert_params(cfg, torch.Generator().manual_seed(seed), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_rows_do_not_depend_on_padding_or_batch_mates_on_the_cpu(dtype, pooling):
    """A row's embedding is the same alone at its own length, padded to 64
    positions, and beside other rows in a batch of 8. Beside batch-mates:
    bitwise in both dtypes. Padded: bitwise in bf16 (the embedder's
    dtype: its batched and synchronous paths rely on it); in f32 the
    softmax and P·V sums over another length may differ by an f32 ulp,
    so there max |Δ| <= 1e-7 (observed 1.5e-8)."""
    cfg = dataclasses.replace(tbert.BERT_PRESETS["debug"], pooling=pooling)
    params = _port_params(cfg, dtype)
    rng = np.random.RandomState(5)
    rows = [rng.randint(0, 512, n).tolist() for n in (7, 30, 19, 1, 64, 12, 33, 50)]

    def encode(batch, T):
        ids = torch.zeros((len(batch), T), dtype=torch.int32)
        mask = torch.zeros((len(batch), T), dtype=torch.int32)
        for i, r in enumerate(batch):
            ids[i, : len(r)] = torch.tensor(r)
            mask[i, : len(r)] = 1
        return tbert.bert_encode(params, cfg, ids, mask)

    together = encode(rows, 64)
    for i, r in enumerate(rows):
        assert torch.equal(encode([r], 64)[0], together[i]), i
        alone = encode([r], len(r))[0]
        if dtype == torch.bfloat16:
            assert torch.equal(alone, together[i]), i
        else:
            assert float((alone - together[i]).abs().max()) <= 1e-7, i


def test_conversion_round_trip_is_bit_exact():
    cfg = jbert.BERT_PRESETS["debug"]
    key = jax.random.PRNGKey(7)
    params = jbert.init_bert_params(cfg, key)  # bf16
    head = jbert.init_rank_head(cfg, jax.random.fold_in(key, 1))
    tree = _tree(params)
    port = bert_params_from_numpy(tree)
    assert len(port["layers"]) == cfg.num_layers
    for name, arr in tree.items():
        if name == "layers":
            continue
        assert port[name].dtype == torch.bfloat16
        back = port[name].view(torch.uint16).numpy()
        assert np.array_equal(back, np.asarray(arr).view(np.uint16)), name
    for name, stacked in tree["layers"].items():
        for i in range(cfg.num_layers):
            assert np.array_equal(port["layers"][i][name].view(torch.uint16).numpy(),
                                  np.asarray(stacked)[i].view(np.uint16)), (name, i)
    th = rank_head_from_numpy(_tree(head))
    assert set(th) == {"w", "b"} and th["w"].dtype == torch.bfloat16
    assert np.array_equal(th["w"].view(torch.uint16).numpy(), np.asarray(head["w"]).view(np.uint16))


def test_the_port_draws_the_jax_shapes_and_init_rule():
    cfg = tbert.BERT_PRESETS["debug"]
    jcfg = jbert.BERT_PRESETS["debug"]
    jtree = _tree(jbert.init_bert_params(jcfg, jax.random.PRNGKey(0)))
    port = _port_params(cfg)
    for name, arr in jtree.items():
        if name != "layers":
            assert tuple(port[name].shape) == arr.shape and port[name].dtype == torch.bfloat16
    for name, stacked in jtree["layers"].items():
        assert tuple(port["layers"][0][name].shape) == stacked.shape[1:], name
    # norm scales 1, biases 0, weights N(0, 0.02)
    assert torch.equal(port["embed_norm_scale"], torch.ones(cfg.hidden_size, dtype=torch.bfloat16))
    assert not port["layers"][0]["bq"].any()
    std = float(port["layers"][0]["w_in"].float().std())
    assert 0.018 < std < 0.022
    again = _port_params(cfg)
    assert torch.equal(port["tok_embed"], again["tok_embed"])  # seeded


@pytest.mark.parametrize("preset,layers,hidden,heads,ffn,matmul", [
    ("arctic-embed-l", 24, 1024, 16, 4096, 301_989_888),
    ("arctic-embed-m", 12, 768, 12, 3072, 84_934_656),
])
def test_arctic_presets_on_the_meta_device(preset, layers, hidden, heads, ffn, matmul):
    """The full-width presets, built as shapes only (no memory, no forward
    pass): the JAX presets' numbers, and the matmul parameter count."""
    cfg = tbert.BERT_PRESETS[preset]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jbert.BERT_PRESETS[preset])
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            cfg.max_positions, cfg.vocab_size) == (layers, hidden, heads, ffn, 512, 30522)
    top, layer = tbert.param_shapes(cfg)
    meta = {k: torch.empty(s, device="meta", dtype=torch.bfloat16) for k, s in top.items()}
    meta_layer = {k: torch.empty(s, device="meta", dtype=torch.bfloat16) for k, s in layer.items()}
    per_layer = sum(t.numel() for k, t in meta_layer.items() if k.startswith("w"))
    assert per_layer * cfg.num_layers == tbert.matmul_params(cfg) == matmul
    assert meta["tok_embed"].shape == (30522, hidden)
    total = sum(t.numel() for t in meta.values()) + cfg.num_layers * sum(
        t.numel() for t in meta_layer.values())
    assert 2 * total / 1e9 == pytest.approx({"arctic-embed-l": 0.67, "arctic-embed-m": 0.22}[preset],
                                            abs=0.01)


def test_load_bert_params_names_its_roadmap_item(tmp_path):
    """Loading BERT weights (refused until ROADMAP queue 1 item 10) is
    served as JAX serves it: a directory with no safetensors raises
    FileNotFoundError, and a written HF checkpoint (``bert.`` names,
    Linear weights ``[out, in]``) loads the same tensors, bit for bit."""
    from generativeaiexamples_tpu_torch.utils import safetensors_io

    cfg = tbert.BERT_PRESETS["debug"]
    with pytest.raises(FileNotFoundError):
        tbert.load_bert_params(str(tmp_path / "missing"), cfg)
    params = tbert.init_bert_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    safetensors_io.save_file(tbert.hf_tensors(params), str(tmp_path / "model.safetensors"))
    got = tbert.load_bert_params(str(tmp_path), cfg, torch.float32)
    assert set(got) == set(params)
    for key, val in params.items():
        if key != "layers":
            assert torch.equal(got[key], val), key
    for lp, want in zip(got["layers"], params["layers"]):
        assert set(lp) == set(want) and all(torch.equal(lp[k], want[k]) for k in want)
