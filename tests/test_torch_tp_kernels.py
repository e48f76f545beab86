"""Tensor-parallel serving's pieces in the port against the JAX package's:
the per-shard int8 packs (byte for byte), the Megatron cuts of
parallel/sharding.py (each shard's tile equal to the JAX NamedSharding's
piece on that device), the TP launchers of parallel/tp_kernels.py (the
port's wrappers run their plain versions on CPU tensors, on a mesh of N
``cpu`` shards; JAX's run the Pallas kernels in interpret mode through
``shard_map`` on the 8-device virtual CPU mesh), and the row reduce."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu.parallel import sharding as jsharding
from generativeaiexamples_tpu.parallel import tp_kernels as jtp
from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models.convert import params_from_jax, to_tensor
from generativeaiexamples_tpu_torch.ops import int8_matmul as tim
from generativeaiexamples_tpu_torch.ops import quant as tquant
from generativeaiexamples_tpu_torch.parallel import create_mesh, sharding
from generativeaiexamples_tpu_torch.parallel import tp_kernels as ttp
from generativeaiexamples_tpu_torch.parallel.sharding import Shards

SHARDS = (2, 4, 8)
# Both sides sum exact f32 products and round once to bf16 per shard; the
# row reduce adds the shards' bf16 partials in f32 (JAX's psum may add in
# another order) and rounds again: two bf16 steps of the largest output.
MATMUL_ATOL = 2.0 * 2.0**-7
# the attention kernels' own comparison bound (tests/test_torch_page_attention.py)
ATTN_ATOL = 0.02


def _tp(n):
    return ttp.TPContext(create_mesh(n, devices=["cpu"] * n), n)


def _jtp(n):
    return jtp.TPContext(jcreate_mesh(tensor_parallelism=n), n, interpret=True)


def _t(a):
    return to_tensor(np.asarray(a))


def _gather_kv(layers):
    """Sharded caches whole again, on the first shard's device: the int8
    fixed cache (4-d scales) on its axis 1, pools and bf16 strips on 2."""
    first = layers[0][0]
    head_major = "ks" in first and first["ks"].dim() == 4
    axes = (sharding.kv_cache_layer_specs(True) if head_major
            else sharding.kv_pool_specs("ks" in first))
    return [{k: torch.cat([p[k].to(first["k"].device) for p in layer], dim=axes[k])
             for k in layer[0]} for layer in layers]


# ------------------------------------------------------------------ //
# per-shard packs


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("kind", ["column", "row"])
def test_tp_packs_equal_jax_byte_for_byte(n, kind):
    """K and F no multiple of the kernel's blocks: every shard pads its own
    tile, as JAX lays it out; the device and the host packers agree."""
    rng = np.random.default_rng(n)
    K, F = (200, n * 72) if kind == "column" else (n * 40, 300)
    w = rng.standard_normal((K, F)).astype(np.float32)
    ref = jquant.quantize_int8(jnp.asarray(w), tp_shards=n, kind=kind)
    ref_host = jquant._quantize_int8_host(w, tp_shards=n, kind=kind)
    for mine in (tquant.quantize_int8(torch.from_numpy(w), n, kind),
                 tquant._quantize_int8_host(w, n, kind)):
        for key in ("q", "scale"):
            assert mine[key].numpy().tobytes() == np.asarray(ref[key]).tobytes(), key
            assert mine[key].numpy().tobytes() == np.asarray(ref_host[key]).tobytes(), key
    got = tquant.dequantize_int8(tquant.quantize_int8(torch.from_numpy(w), n, kind), torch.float32,
                                 K, n, kind)
    want = jquant.dequantize_int8(ref, jnp.float32, k_features=K, tp_shards=n, kind=kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["column", "row"])
def test_tp_packs_refuse_indivisible_axes(kind):
    with pytest.raises(ValueError, match="not divisible"):
        tquant.quantize_int8(torch.zeros(100, 100), 8, kind)
    with pytest.raises(ValueError, match="not divisible"):
        tquant._quantize_int8_host(np.zeros((100, 100), np.float32), 8, kind)


@pytest.mark.parametrize("n", SHARDS)
def test_quantize_params_int8_tp_equals_jax(n):
    """Unfused under TP, every pack in its kind's per-shard layout, byte
    for byte JAX's."""
    cfg = jllama.PRESETS["debug-8dev"]
    dense = jllama.init_params(cfg, jax.random.PRNGKey(n), jnp.float32)
    ref = params_from_jax(jquant.quantize_params_int8(dense, tp_shards=n))
    mine = tquant.quantize_params_int8(params_from_jax(dense), tp_shards=n)
    assert "wqkv" not in mine["layers"][0] and "w_gateup" not in mine["layers"][0]
    assert sorted(mine["layers"][0]) == sorted(ref["layers"][0])
    for lp, rp in zip(mine["layers"], ref["layers"]):
        for key, val in rp.items():
            if isinstance(val, dict):
                assert torch.equal(lp[key]["q"], val["q"]) and torch.equal(lp[key]["scale"], val["scale"]), key
    assert torch.equal(mine["lm_head"]["q"], ref["lm_head"]["q"])


@pytest.mark.parametrize("n", SHARDS)
def test_init_packed_params_int8_tp_is_the_single_device_draw_laid_out_again(n):
    """JAX's structure, shapes and scales at ``tp_shards=n``; the integers
    are the one-shard draw of the same seed, so every shard count computes
    one function."""
    cfg = tllama.PRESETS["debug-8dev"]
    ref = params_from_jax(jquant.init_packed_params_int8(jllama.PRESETS["debug-8dev"], seed=0,
                                                         dtype=jnp.bfloat16, tp_shards=n))
    mine = tquant.init_packed_params_int8(cfg, seed=3, tp_shards=n)
    one = tquant.init_packed_params_int8(cfg, seed=3)
    for lp, rp, op in zip(mine["layers"], ref["layers"], one["layers"]):
        assert sorted(lp) == sorted(rp)
        for key, val in rp.items():
            if isinstance(val, dict):
                assert lp[key]["q"].shape == val["q"].shape and torch.equal(lp[key]["scale"], val["scale"])
        fused_q = tquant.dequantize_int8(op["wqkv"], torch.float32, cfg.hidden_size)
        parts = [tquant.dequantize_int8(lp[k], torch.float32, cfg.hidden_size, n, "column")
                 for k in ("wq", "wk", "wv")]
        assert torch.equal(fused_q, torch.cat(parts, dim=-1))
        down = tquant.dequantize_int8(lp["w_down"], torch.float32, cfg.intermediate_size, n, "row")
        assert torch.equal(down, tquant.dequantize_int8(op["w_down"], torch.float32,
                                                        cfg.intermediate_size))


# ------------------------------------------------------------------ //
# the Megatron cuts


def _jax_pieces(arr, spec, mesh):
    """The JAX NamedSharding's piece on each device of the model axis."""
    placed = jax.device_put(arr, NamedSharding(mesh, spec))
    by_dev = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    return [by_dev[d] for d in mesh.devices.reshape(-1)]


@pytest.mark.parametrize("n", SHARDS)
def test_shard_params_cuts_each_leaf_as_jax_places_it(n):
    """A JAX TP tree carried across (``params_from_jax(tree, mesh=)``): every
    shard's tile is the piece JAX's ``shard_params_layered`` puts on that
    device; replicated leaves stay whole on the first shard's device."""
    cfg = jllama.PRESETS["debug-8dev"]
    jtree = jllama.consume_split_params_layers(
        jquant.quantize_params_int8(jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32),
                                    tp_shards=n))
    mesh = jcreate_mesh(tensor_parallelism=n)
    mine = params_from_jax(jax.tree.map(np.asarray, jtree), mesh=create_mesh(n, devices=["cpu"] * n))
    lspecs = jsharding.layer_param_specs()
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        packs = jsharding._int8_pack_specs(lspecs[key])
        assert isinstance(mine["layers"][1][key], Shards) and len(mine["layers"][1][key]) == n
        for leaf in ("q", "scale"):
            pieces = _jax_pieces(jtree["layers"][1][key][leaf], packs[leaf], mesh)
            for i in range(n):
                assert np.array_equal(mine["layers"][1][key][i][leaf].numpy(), pieces[i]), (key, leaf, i)
    head = _jax_pieces(jtree["lm_head"]["q"], jsharding.param_specs()["lm_head"], mesh)
    assert all(np.array_equal(mine["lm_head"][i]["q"].numpy(), head[i]) for i in range(n))
    assert not isinstance(mine["embed"], Shards) and not isinstance(mine["layers"][0]["attn_norm"], Shards)
    assert sharding.is_sharded(mine)
    assert all(piece["q"].shape == mine["layers"][0]["wq"][0]["q"].shape for piece in mine["layers"][0]["wq"])


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("kind", ["pool_bf16", "pool_int8", "fixed_bf16", "fixed_int8"])
def test_kv_cuts_follow_jax_specs(n, kind):
    """Page pools and fixed caches cut on their KV-head axis as
    ``kv_pool_specs`` / ``kv_cache_layer_specs`` place them; gathered back
    whole they are the cache that was cut."""
    rng = np.random.default_rng(n)
    quantized = kind.endswith("int8")
    if kind.startswith("pool"):
        shapes = {"k": (6, 4, 8, 16), "v": (6, 4, 8, 16)}
        if quantized:
            shapes.update(ks=(6, 4, 8), vs=(6, 4, 8))
        specs, cut = jsharding.kv_pool_specs(quantized), sharding.shard_kv_pool
    else:
        shapes = ({"k": (2, 8, 32, 16), "v": (2, 8, 32, 16), "ks": (2, 8, 1, 32), "vs": (2, 8, 1, 32)}
                  if quantized else {"k": (2, 32, 8, 16), "v": (2, 32, 8, 16)})
        specs, cut = jsharding.kv_cache_layer_specs(quantized), sharding.shard_kv_cache_layered
    layer = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mine = cut([{k: torch.from_numpy(v) for k, v in layer.items()}], create_mesh(n, devices=["cpu"] * n))
    mesh = jcreate_mesh(tensor_parallelism=n)
    for key, arr in layer.items():
        pieces = _jax_pieces(jnp.asarray(arr), specs[key], mesh)
        assert all(np.array_equal(mine[0][i][key].numpy(), pieces[i]) for i in range(n)), key
    whole = _gather_kv(mine)[0]
    assert all(np.array_equal(whole[k].numpy(), layer[k]) for k in layer)


@pytest.mark.parametrize("name", sorted(tllama.PRESETS))
@pytest.mark.parametrize("n", (1,) + SHARDS)
def test_supports_model_config_agrees_with_jax(name, n):
    assert ttp.supports_model_config(tllama.PRESETS[name], n) == \
        jtp.supports_model_config(jllama.PRESETS[name], n)


def test_tp_context_is_the_mesh_size():
    with pytest.raises(ValueError, match="2 shards on a mesh of 4"):
        ttp.TPContext(create_mesh(4, devices=["cpu"] * 4), 2)


# ------------------------------------------------------------------ //
# the launchers


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
@pytest.mark.parametrize("kind,K,F", [("column", 256, 1024), ("row", 1024, 512)])
@pytest.mark.parametrize("M", [4, 96])  # the kernel at decode shapes, the prefill path above M_MAX
def test_packed_matmul_tp_matches_jax(mode, kind, K, F, M):
    n = 8
    rng = np.random.default_rng(M + K)
    w = jnp.asarray(rng.standard_normal((K, F)).astype(np.float32) * 0.05)
    x = jnp.asarray(rng.standard_normal((2, M // 2, K)).astype(np.float32) * 0.5, jnp.bfloat16)
    pack = jquant.quantize_int8(w, tp_shards=n, kind=kind)
    ref = np.asarray(jtp.packed_matmul_tp(x, pack, _jtp(n), kind, w8a8=mode == "w8a8"), np.float32)
    axis = -1 if kind == "column" else -2
    tp = _tp(n)
    tiles = sharding._put({k: _t(v) for k, v in pack.items()}, axis, tp.mesh)
    got = ttp.packed_matmul_tp(_t(x), tiles, tp, kind, mode)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, M // 2, F)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=MATMUL_ATOL * np.abs(ref).max())


@pytest.mark.parametrize("n", SHARDS)
def test_row_reduce_rounds_each_partial_to_bf16_then_sums_in_f32(n):
    """JAX's ``psum(y.astype(f32)).astype(y.dtype)`` over bf16 partials:
    each shard's output is already rounded to bf16, the sum is f32 in
    shard order, one rounding at the end; a dense row tile takes the same
    reduce."""
    rng = np.random.default_rng(n)
    tp = _tp(n)
    K, F = 64 * n, 48
    x = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((K, F)).astype(np.float32) * 0.1)
    pack = tquant.quantize_int8(w, n, "row")
    tiles = sharding._put(pack, -2, tp.mesh)
    parts = [tim.packed_matmul(xs, tile) for xs, tile in zip(ttp.scatter(x, tp, -1), tiles)]
    assert all(p.dtype == torch.bfloat16 for p in parts)
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    assert torch.equal(ttp.packed_matmul_tp(x, tiles, tp, "row"), want.to(torch.bfloat16))
    assert torch.equal(ttp.reduce_sum(parts, tp), want.to(torch.bfloat16))
    dense = sharding.cut(w.to(torch.bfloat16), n, -2, tp.devices)
    dparts = [xs @ wl for xs, wl in zip(ttp.scatter(x, tp, -1), dense)]
    dwant = dparts[0].float()
    for p in dparts[1:]:
        dwant = dwant + p.float()
    assert torch.equal(ttp.packed_matmul_tp(x, dense, tp, "row"), dwant.to(torch.bfloat16))


def test_flash_attention_tp_matches_jax():
    n, B, T, Hq, Hkv, D = 8, 1, 40, 16, 8, 16
    rng = np.random.default_rng(4)
    q, k, v = (jnp.asarray(rng.standard_normal((B, T, h, D)), jnp.bfloat16) for h in (Hq, Hkv, Hkv))
    ref = np.asarray(jtp.flash_attention_tp(q, k, v, _jtp(n)), np.float32)
    got = ttp.flash_attention_tp(_t(q), _t(k), _t(v), _tp(n))
    assert tuple(got.shape) == (B, T, Hq, D)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
def test_paged_attention_tp_matches_jax(kv_dtype):
    """Each shard reads its own pool of Hkv/N heads; tables and positions
    replicated (a dead row at 0, one-page and full rows)."""
    n, B, T, Hq, Hkv, Dh, page, P = 8, 3, 1, 16, 8, 16, 8, 12
    rng = np.random.default_rng(7)
    tables = np.zeros((B, 4), np.int32)
    tables[1, :1] = [1]
    tables[2, :] = [2, 3, 4, 5]
    positions = np.asarray([0, 5, 4 * page - 1], np.int32)
    q = jnp.asarray(rng.standard_normal((B, T, Hq, Dh)), jnp.bfloat16)
    raw = [jnp.asarray(rng.standard_normal((P, page, Hkv, Dh)), jnp.float32) for _ in range(2)]
    if kv_dtype == "bfloat16":
        (k, v), scales = (r.astype(jnp.bfloat16) for r in raw), ()
    else:
        codec = jllama.quantize_kv if kv_dtype == "int8" else jllama.quantize_kv_int4
        (k, ks), (v, vs) = codec(raw[0]), codec(raw[1])
        scales = (ks, vs)
    ref = jtp.paged_attention_tp(q, k, v, jnp.asarray(tables), jnp.asarray(positions), *scales,
                                 tp=_jtp(n))
    tp = _tp(n)
    cut = sharding.shard_kv_pool([{"k": _t(k), "v": _t(v), **dict(zip(("ks", "vs"), map(_t, scales)))}],
                                 tp.mesh)[0]
    fields = [Shards(c[key] for c in cut) for key in ("k", "v", "ks", "vs") if key in cut[0]]
    got = ttp.paged_attention_tp(_t(q), fields[0], fields[1], torch.from_numpy(tables),
                                 torch.from_numpy(positions), *fields[2:], tp=tp)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=ATTN_ATOL)


def test_decode_attention_tp_matches_jax():
    """The int8 head-major fixed cache, heads sharded (kernel-8dev's
    geometry: 8 query heads a shard, one KV head)."""
    n, B, S, Hq, Hkv, Dh = 8, 2, 256, 64, 8, 128
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((B, Hq, Dh)), jnp.bfloat16)
    kq, ks = jllama.quantize_kv(jnp.asarray(rng.standard_normal((B, Hkv, S, Dh)), jnp.float32))
    vq, vs = jllama.quantize_kv(jnp.asarray(rng.standard_normal((B, Hkv, S, Dh)), jnp.float32))
    ks4, vs4 = ks.reshape(B, Hkv, 1, S), vs.reshape(B, Hkv, 1, S)
    positions = jnp.asarray([S - 1, 17], jnp.int32)
    ref = jtp.decode_attention_tp(q, kq, ks4, vq, vs4, positions, _jtp(n))
    tp = _tp(n)
    cut = sharding.shard_kv_cache_layered(
        [{"k": _t(kq), "v": _t(vq), "ks": _t(ks4), "vs": _t(vs4)}], tp.mesh)[0]
    f = {key: Shards(c[key] for c in cut) for key in ("k", "ks", "v", "vs")}
    got = ttp.decode_attention_tp(_t(q), f["k"], f["ks"], f["v"], f["vs"], _t(positions), tp)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("n", SHARDS)
def test_each_launcher_calls_its_wrapper_once_a_shard(monkeypatch, n):
    """A TP=N call reaches each kernel's wrapper N times, once on each
    shard's local tile: the counts the card's launch counters add up."""
    from generativeaiexamples_tpu_torch.ops import flash_attention, page_attention

    seen = []

    def recording(mod, name):
        orig = getattr(mod, name)

        def wrapper(first, *args, **kwargs):
            seen.append((name, tuple(first.shape)))
            return orig(first, *args, **kwargs)

        monkeypatch.setattr(mod, name, wrapper)

    recording(tim, "packed_matmul")
    recording(flash_attention, "flash_attention_causal")
    recording(page_attention, "paged_attention")
    tp = _tp(n)
    x = torch.randn(2, 16 * n, dtype=torch.bfloat16)
    w = sharding._put(tquant.quantize_int8(torch.randn(16 * n, 8 * n)), -1, tp.mesh)
    assert tuple(ttp.packed_matmul_tp(x, w, tp, "column").shape) == (2, 8 * n)
    q = torch.randn(1, 4, 2 * n, 16, dtype=torch.bfloat16)
    kv = torch.randn(1, 4, n, 16, dtype=torch.bfloat16)
    ttp.flash_attention_tp(q, kv, kv, tp)
    pool = sharding.shard_kv_pool([{"k": torch.zeros(3, 4, n, 16, dtype=torch.bfloat16),
                                    "v": torch.zeros(3, 4, n, 16, dtype=torch.bfloat16)}], tp.mesh)[0]
    ttp.paged_attention_tp(q[:, :1], Shards(c["k"] for c in pool), Shards(c["v"] for c in pool),
                           torch.ones((1, 2), dtype=torch.int32), torch.tensor([3], dtype=torch.int32),
                           tp=tp)
    assert [name for name, _ in seen] == (
        ["packed_matmul"] * n + ["flash_attention_causal"] * n + ["paged_attention"] * n
    )
    assert {shape for name, shape in seen if name != "packed_matmul"} == {(1, 4, 2, 16), (1, 1, 2, 16)}
