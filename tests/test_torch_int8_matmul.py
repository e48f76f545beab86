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
    torch.testing.assert_close(tim.packed_matmul(x, tp, use_kernel=False), small)
    big = x.reshape(1, 12, 64).expand(11, 12, 64)  # M = 132 > M_MAX
    torch.testing.assert_close(
        tim.packed_matmul(big, tp), tim.int8_matmul_dequant(big, tp["q"], tp["scale"])
    )
    with pytest.raises(ValueError, match="decode-shaped"):
        tim.int8_matmul(big, tp["q"], tp["scale"])


def test_split_k_plan_covers_k_within_the_kernels_limits():
    for K, F_pad in ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128512), (64, 512)):
        splits, k_chunk = tim._split_k(K, F_pad // tim.F_BLK)
        assert k_chunk <= tim._MAX_K_CHUNK and k_chunk % 32 == 0
        assert (splits - 1) * k_chunk < K <= splits * k_chunk


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
