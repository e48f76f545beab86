"""Causal GQA flash attention: the port's plain version (what its CUDA
wrapper runs on CPU tensors) against the Pallas kernel in interpret mode,
with GQA and a T that is not a multiple of the block, plus the
kernel-selection policy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import flash_attention as jfa
from generativeaiexamples_tpu_torch.models.convert import to_tensor
from generativeaiexamples_tpu_torch.ops import flash_attention as tfa


@pytest.mark.parametrize(
    "B,T,Hq,Hkv,D,block",
    [
        (2, 40, 4, 2, 16, 16),  # GQA, T = 2.5 blocks (padding path)
        (1, 33, 8, 1, 32, 16),  # MQA, ragged T
        (2, 32, 4, 4, 16, 16),  # MHA, exact blocks
    ],
)
def test_plain_matches_pallas_interpret(B, T, Hq, Hkv, D, block):
    rng = np.random.default_rng(T)
    q = jnp.asarray(rng.standard_normal((B, T, Hq, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    ref = jfa.flash_attention_causal(q, k, v, block_q=block, block_k=block, interpret=True)
    out = tfa.flash_attention_causal(*(to_tensor(np.asarray(a)) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, T, Hq, D)
    # Both compute in f32 from the same bf16 inputs and round the output
    # to bf16 once; |out| < ~3, so one bf16 step is < 0.016.
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=0.02)


def test_first_token_attends_only_itself():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 5, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 5, 1, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 5, 1, 16)).astype(np.float32))
    out = tfa.flash_attention_causal(q, k, v)
    torch.testing.assert_close(out[0, 0, 0], v[0, 0, 0])
    torch.testing.assert_close(out[0, 0, 1], v[0, 0, 0])


def test_selection_policy_matches_jax_crossover():
    assert tfa.MIN_T == 512
    assert tfa.supported(512, 128) and tfa.supported(2, 64)
    assert not tfa.supported(1, 128) and not tfa.supported(512, 16)
    assert jfa.supported(512, 128) == tfa.supported(512, 128)
    cuda = torch.device("cuda")
    assert tfa.preferred(512, 128, cuda)
    assert not tfa.preferred(511, 128, cuda)  # below the crossover: einsum path
    assert not tfa.preferred(512, 128, torch.device("cpu"))  # off the card, as off the TPU
