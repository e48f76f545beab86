"""int8 weight-only matmul and packing, port against the JAX package.

Inputs come from numpy seeds and go through both packages. On the CPU the
port's kernel wrapper runs its plain version, which is checked against the
Pallas kernel in interpret mode (as tests/test_int8.py runs it); the
dequant path is checked against ``int8_matmul_xla``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jllama
from generativeaiexamples_tpu.ops import int8_matmul as jim
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch.models import llama as tllama
from generativeaiexamples_tpu_torch.models.convert import params_from_jax, to_tensor
from generativeaiexamples_tpu_torch.ops import int8_matmul as tim
from generativeaiexamples_tpu_torch.ops import quant as tquant


def _bf16(a):
    """numpy -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, to_tensor(np.asarray(j))


def test_layout_constants_match():
    assert (tim.F_BLK, tim.K_ALIGN, tim.M_MAX) == (jim.F_BLK, jim.K_ALIGN, jim.M_MAX)


@pytest.mark.parametrize("shape", [(64, 96), (200, 700), (2, 64, 96)])
def test_packs_bitwise_equal_to_both_jax_packers(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 0.05
    mine = tquant.quantize_int8(torch.from_numpy(w))
    host = tquant._quantize_int8_host(w)
    for ref in (jquant._quantize_int8_host(w), jquant.quantize_int8(jnp.asarray(w))):
        np.testing.assert_array_equal(mine["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_array_equal(mine["scale"].numpy(), np.asarray(ref["scale"]))
        np.testing.assert_array_equal(host["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_array_equal(host["scale"].numpy(), np.asarray(ref["scale"]))


def test_dequantize_matches_jax():
    w = np.random.default_rng(1).standard_normal((100, 300)).astype(np.float32)
    packed = jquant.quantize_int8(jnp.asarray(w))
    ref = jquant.dequantize_int8(packed, jnp.float32, k_features=100)
    mine = tquant.dequantize_int8(
        {k: to_tensor(np.asarray(v)) for k, v in packed.items()}, torch.float32, k_features=100
    )
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("M,K,F", [(1, 64, 96), (5, 200, 700), (32, 128, 512)])
def test_plain_kernel_matches_pallas_interpret(M, K, F):
    rng = np.random.default_rng(M)
    packed = jquant.quantize_int8(jnp.asarray(rng.standard_normal((K, F)) * 0.1, jnp.float32))
    xj, xt = _bf16(rng.standard_normal((M, K)))
    ref = np.asarray(jim.int8_matmul(xj, packed["q"], packed["scale"], interpret=True), np.float32)
    out = tim.int8_matmul(xt, to_tensor(np.asarray(packed["q"])), to_tensor(np.asarray(packed["scale"])))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, F)
    # Both sum exact f32 products of bf16 x int8 and scale after the sum;
    # only the f32 summation order differs, so the bf16 results differ by
    # at most one rounding step: 2^-7 of the largest output.
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2.0**-7 * np.abs(ref).max())


@pytest.mark.parametrize("M,K,F", [(4, 200, 700), (16, 200, 700), (4, 1000, 512), (16, 333, 96)])
def test_plain_kernel_matches_pallas_interpret_at_padded_and_two_group_m(M, K, F):
    """M below and above the CUDA kernel's 8-row group, K no multiple of its
    16-row mma step (200, 1000) or of anything (333)."""
    rng = np.random.default_rng(100 + M + K)
    packed = jquant.quantize_int8(jnp.asarray(rng.standard_normal((K, F)) * 0.1, jnp.float32))
    xj, xt = _bf16(rng.standard_normal((M, K)))
    ref = np.asarray(jim.int8_matmul(xj, packed["q"], packed["scale"], interpret=True), np.float32)
    out = tim.int8_matmul(xt, to_tensor(np.asarray(packed["q"])), to_tensor(np.asarray(packed["scale"])))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, F)
    # exact f32 products on both sides, scale after the sum: one bf16
    # rounding step of the largest output
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2.0**-7 * np.abs(ref).max())


@pytest.mark.parametrize(
    "K,F_pad",
    [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128512), (64, 512),
     (200, 1024), (1000, 512), (129, 512)],
)
def test_mma_plan_covers_k_in_whole_rounds(K, F_pad):
    splits, k_chunk = tim.mma_plan(K, F_pad)
    assert splits >= 1 and k_chunk % tim._MMA_K_ROUND == 0
    assert (splits - 1) * k_chunk < K <= splits * k_chunk  # covers K, no empty split
    tiles = F_pad // tim._MMA_TILE_F
    if 2 * tiles > tim._TARGET_BLOCKS:
        assert splits == 1  # the column tiles fill the card: no partials, no summing block
    else:  # one wave of blocks, and more than half of it unless K runs out of rounds
        assert tiles * splits <= tim._TARGET_BLOCKS
        assert 2 * tiles * splits > tim._TARGET_BLOCKS or k_chunk == tim._MMA_K_ROUND


def test_mma_plan_gives_the_lm_head_one_split_and_the_narrow_projections_many():
    assert tim.mma_plan(4096, 128512)[0] == 1 and tim.mma_plan(4096, 28672)[0] == 1
    assert tim.mma_plan(4096, 4096)[0] > 1 and tim.mma_plan(14336, 4096)[0] > 1


def test_dequant_path_matches_int8_matmul_xla():
    rng = np.random.default_rng(3)
    K, F, M = 200, 700, 150  # M > M_MAX: the prefill path
    packed = jquant.quantize_int8(jnp.asarray(rng.standard_normal((K, F)) * 0.1, jnp.float32))
    xj, xt = _bf16(rng.standard_normal((M, K)))
    ref = np.asarray(jim.int8_matmul_xla(xj, packed["q"], packed["scale"]), np.float32)
    tp = {k: to_tensor(np.asarray(v)) for k, v in packed.items()}
    out = tim.packed_matmul(xt, tp)
    # Same formula (bf16 weights, one bf16 matmul with f32 accumulation):
    # one bf16 rounding step of the largest output.
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2.0**-7 * np.abs(ref).max())


def test_packed_matmul_dispatches_by_m():
    rng = np.random.default_rng(4)
    tp = tquant.quantize_int8(torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((3, 4, 64)).astype(np.float32)).to(torch.bfloat16)
    small = tim.packed_matmul(x, tp)
    assert tuple(small.shape) == (3, 4, 96)
    torch.testing.assert_close(small, tim.int8_matmul_plain(x.reshape(12, 64), tp["q"], tp["scale"]).reshape(3, 4, 96))
    torch.testing.assert_close(tim.packed_matmul(x, tp, "int8_plain"), small)
    big = x.reshape(1, 12, 64).expand(11, 12, 64)  # M = 132 > M_MAX
    torch.testing.assert_close(
        tim.packed_matmul(big, tp), tim.int8_matmul_dequant(big, tp["q"], tp["scale"])
    )
    with pytest.raises(ValueError, match="decode-shaped"):
        tim.int8_matmul(big, tp["q"], tp["scale"])


@pytest.mark.parametrize(
    "K,F_pad",
    [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128512), (64, 512),
     (200, 1024), (1000, 512), (333, 1536), (14336, 1024), (8200, 129024)],
)
def test_w8a8_plan_covers_k_in_whole_k32_rounds_within_one_wave(K, F_pad):
    """The W8A8 kernel's split plan: the five llama3-8b shapes and odd K;
    whole rounds of the 8 warps' k32 steps, no empty split, one wave of
    blocks, and more than half of one unless K runs out of rounds."""
    splits, k_chunk = tim.w8a8_plan(K, F_pad)
    assert k_chunk % tim._W8A8_K_ROUND == 0
    assert (splits - 1) * k_chunk < K <= splits * k_chunk
    tiles = F_pad // tim._MMA_TILE_F
    if 2 * tiles > tim._TARGET_BLOCKS:
        assert splits == 1  # the lm_head and w_gateup: no partials, no summing block
    else:
        assert tiles * splits <= tim._TARGET_BLOCKS
        assert 2 * tiles * splits > tim._TARGET_BLOCKS or k_chunk == tim._W8A8_K_ROUND


def test_w8a8_plan_gives_the_lm_head_one_split():
    assert tim.w8a8_plan(4096, 128512) == (1, 4096) and tim.w8a8_plan(4096, 28672) == (1, 4096)
    assert tim.w8a8_plan(8200, 129024) == (1, 8448)
    assert tim.w8a8_plan(14336, 4096)[0] > 1 and tim.w8a8_plan(4096, 4096)[0] > 1


def test_quantize_params_matches_jax_fused_layout():
    cfg = jllama.PRESETS["debug"]
    import jax

    dense = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    ref = jquant.quantize_params_int8(dense)
    mine = tquant.quantize_params_int8(params_from_jax(dense))
    ref_t = params_from_jax(ref)
    assert sorted(mine["layers"][0]) == sorted(ref_t["layers"][0])
    for lp, rp in zip(mine["layers"], ref_t["layers"]):
        for key in ("wqkv", "w_gateup", "wo", "w_down"):
            assert torch.equal(lp[key]["q"], rp[key]["q"]), key
            assert torch.equal(lp[key]["scale"], rp[key]["scale"]), key
    assert torch.equal(mine["lm_head"]["q"], ref_t["lm_head"]["q"])


def test_init_packed_params_matches_jax_structure():
    cfg = jllama.PRESETS["debug"]
    ref = params_from_jax(jquant.init_packed_params_int8(cfg, seed=0, dtype=jnp.bfloat16))
    mine = tquant.init_packed_params_int8(tllama.PRESETS["debug"], seed=0)
    assert sorted(mine) == sorted(ref)
    assert len(mine["layers"]) == len(ref["layers"]) == cfg.num_layers
    for lp, rp in zip(mine["layers"], ref["layers"]):
        assert sorted(lp) == sorted(rp)
        for key, val in rp.items():
            if isinstance(val, dict):
                assert lp[key]["q"].shape == val["q"].shape and lp[key]["q"].dtype == torch.int8
                # scales are deterministic (std / 73): equal bit for bit
                assert torch.equal(lp[key]["scale"], val["scale"]), key
                assert int(lp[key]["q"].abs().max()) <= 127
            else:
                assert torch.equal(lp[key], val), key
    assert mine["embed"].shape == ref["embed"].shape and mine["embed"].dtype == torch.bfloat16


def test_quantize_rows_bitwise_equal_to_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((9, 200)).astype(np.float32) * 3
    x[0] = 0  # an all-zero row takes the 1e-8 floor
    for xj in (jnp.asarray(x), jnp.asarray(x, jnp.bfloat16)):
        ref_q, ref_s = jim.quantize_rows(xj)
        q, s = tim.quantize_rows(to_tensor(np.asarray(xj)))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("M,K,F", [(1, 64, 96), (5, 200, 700), (32, 128, 512)])
def test_w8a8_plain_is_bitwise_the_pallas_kernel(M, K, F):
    rng = np.random.default_rng(10 + M)
    packed = jquant.quantize_int8(jnp.asarray(rng.standard_normal((K, F)) * 0.1, jnp.float32))
    xj, xt = _bf16(rng.standard_normal((M, K)))
    ref = np.asarray(jim.int8_w8a8_matmul(xj, packed["q"], packed["scale"], interpret=True))
    out = tim.int8_w8a8_matmul(xt, to_tensor(np.asarray(packed["q"])), to_tensor(np.asarray(packed["scale"])))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, F)
    # both sums are exact integers and the epilogue is the same f32
    # (f32(acc) * sx) * s with one bf16 rounding: equal bit for bit
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), ref.view(np.int16))


@pytest.mark.parametrize("M,K,F", [(1, 64, 96), (8, 300, 700)])
def test_w8a8_plain_is_bitwise_the_pallas_kernel_on_f32_rows(M, K, F):
    """f32 activations (``dtype=float32`` engines) quantize from f32."""
    rng = np.random.default_rng(20 + M)
    packed = jquant.quantize_int8(jnp.asarray(rng.standard_normal((K, F)) * 0.1, jnp.float32))
    x = (rng.standard_normal((M, K)) * 3).astype(np.float32)
    ref = np.asarray(jim.int8_w8a8_matmul(jnp.asarray(x), packed["q"], packed["scale"], interpret=True))
    out = tim.int8_w8a8_matmul(torch.from_numpy(x), to_tensor(np.asarray(packed["q"])),
                               to_tensor(np.asarray(packed["scale"])))
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), ref.view(np.int16))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_w8a8_refuses_other_activation_dtypes(dtype):
    tp = tquant.quantize_int8(torch.ones((64, 96)))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tim.int8_w8a8_matmul(torch.ones((2, 64), dtype=dtype), tp["q"], tp["scale"])


def test_quantize_rows_divides_as_ieee_and_rounds_half_to_even():
    """The kernel's quantizer (``__fdiv_rn``, ``rintf``) is this one: a row
    whose absmax is 127 has s = 1 exactly, so 2.5 -> 2, -3.5 -> -4,
    0.5 -> 0; an all-zero row takes s = 1e-8 and quantizes to zeros."""
    x = torch.tensor([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5], [0.0] * 6])
    q, s = tim.quantize_rows(x)
    assert s[:, 0].tolist() == [1.0, np.float32(1e-8)]
    assert q.tolist() == [[127, 2, -4, 0, 0, 2], [0] * 6]


@pytest.mark.parametrize("max_acc", [None, 150 * 512], ids=["one-product", "column-chunks"])
def test_w8a8_prefill_is_bitwise_int8_matmul_xla_w8a8(monkeypatch, max_acc):
    if max_acc is not None:  # force the output-column chunking
        monkeypatch.setattr(tim, "_MAX_ACC_ELEMS", max_acc)
    rng = np.random.default_rng(12)
    K, F, M = 200, 1300, 150  # M > M_MAX: the prefill path
    packed = jquant.quantize_int8(jnp.asarray(rng.standard_normal((K, F)) * 0.1, jnp.float32))
    xj, xt = _bf16(rng.standard_normal((3, M // 3, K)))
    ref = np.asarray(jim.int8_matmul_xla_w8a8(xj, packed["q"], packed["scale"]))
    tp = {k: to_tensor(np.asarray(v)) for k, v in packed.items()}
    out = tim.packed_matmul(xt, tp, "w8a8")
    assert tuple(out.shape) == (3, M // 3, F)
    np.testing.assert_array_equal(out.view(torch.int16).numpy(), ref.view(np.int16))
    # and the decode formula on the same rows agrees with it bit for bit
    small = tim.packed_matmul(xt[0], tp, "w8a8_plain")
    assert torch.equal(small, out[0])


def test_packed_matmul_refuses_unknown_modes():
    tp = tquant.quantize_int8(torch.ones((64, 96)))
    with pytest.raises(ValueError, match="mode"):
        tim.packed_matmul(torch.ones((1, 64)), tp, "w4a16")
