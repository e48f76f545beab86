"""The port's sampler against the JAX package's, on the same logits from
numpy seeds: the threefry keys and random bits are bitwise JAX's; gumbel
noise differs only where the two libraries' ``log`` round differently (one
f32 ulp); and the sampled tokens are identical for greedy, nucleus
(top_p < 1) and full-vocabulary (top_p = 1) rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import sampling as jsampling
from generativeaiexamples_tpu_torch.models import sampling as tsampling

BASE = jax.random.PRNGKey(1234)


def _key(jkey):
    words = np.asarray(jkey).astype(np.int64)
    return torch.tensor(words[..., 0]), torch.tensor(words[..., 1])


def test_base_key_is_prng_key_1234():
    assert tuple(np.asarray(BASE).tolist()) == tsampling.BASE_KEY


def test_sample_keys_are_bitwise_fold_in():
    rng = np.random.default_rng(0)
    seeds = np.concatenate([[0, 1, 2**31 - 1], rng.integers(0, 2**31 - 1, 61)]).astype(np.int32)
    positions = np.concatenate([[0, 8191, 5], rng.integers(0, 2**20, 61)]).astype(np.int32)
    ref = np.asarray(jsampling.sample_keys(BASE, jnp.asarray(seeds), jnp.asarray(positions)))
    k0, k1 = tsampling.sample_keys(torch.from_numpy(seeds), torch.from_numpy(positions))
    np.testing.assert_array_equal(k0.numpy(), ref[:, 0])
    np.testing.assert_array_equal(k1.numpy(), ref[:, 1])


@pytest.mark.parametrize("data", [0, 7, 2**31 - 1])
def test_random_bits_and_gumbel_match_jax(data):
    jkey = jax.random.fold_in(BASE, data)
    n = 4096
    bits = tsampling.random_bits(_key(jkey), n)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jax.random.bits(jkey, (n,))))
    ref = np.asarray(jax.random.gumbel(jkey, (n,)))
    out = tsampling.gumbel(_key(jkey), n).numpy()
    # same uniforms bit for bit; the two libraries' log may round one f32
    # ulp apart (|gumbel| < ~16, ulp <= 2^-19)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2.0**-18)


@pytest.mark.parametrize("trial", range(4))
def test_sample_tokens_match_jax_token_for_token(trial):
    rng = np.random.default_rng(100 + trial)
    B, V = 12, 512
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    # greedy, nucleus and full-vocabulary rows, mixed
    temps = np.array([0, 0.7, 1.0, 0.5, 1.3, 0.9] * 2, np.float32)
    topps = np.array([0.7, 0.7, 1.0, 1.0, 0.3, 0.95] * 2, np.float32)
    seeds = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    positions = rng.integers(0, 8192, B).astype(np.int32)
    keys = jsampling.sample_keys(BASE, jnp.asarray(seeds), jnp.asarray(positions))
    ref = jsampling.sample_tokens(jnp.asarray(logits), keys, jnp.asarray(temps), jnp.asarray(topps))
    out = tsampling.sample_tokens(
        torch.from_numpy(logits), torch.from_numpy(temps), torch.from_numpy(topps),
        tsampling.sample_keys(torch.from_numpy(seeds), torch.from_numpy(positions)),
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_rows_draw_independently_of_their_batch():
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((6, 300)).astype(np.float32))
    temps, topps = torch.full((6,), 0.8), torch.tensor([1.0, 0.9, 1.0, 0.5, 1.0, 0.99])
    keys = tsampling.sample_keys(torch.arange(6) * 17, torch.arange(6) + 40)
    whole = tsampling.sample_tokens(logits, temps, topps, keys)
    for i in range(6):
        one = tsampling.sample_tokens(
            logits[i:i + 1], temps[i:i + 1], topps[i:i + 1], (keys[0][i:i + 1], keys[1][i:i + 1])
        )
        assert int(one) == int(whole[i])
