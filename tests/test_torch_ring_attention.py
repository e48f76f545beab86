"""``parallel/ring_attention.py`` against the JAX package's, on the same
numpy inputs: JAX's ``ring_attention`` runs on conftest's 8 virtual CPU
devices (``shard_map`` over the ``seq`` axis), the port's over a mesh of
``cpu`` seq shards, at JAX's two cases (tests/test_parallel.py: seq 8,
B 2, T 32, H 4, D 8; GQA seq 4, Hq 4, Hkv 2).

Tolerance: rtol and atol 1e-5, JAX's own for the ring against its
reference; both sides run the same f32 online softmax in the same hop
order, so they agree far inside it.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.parallel.mesh import create_mesh as jcreate_mesh
from generativeaiexamples_tpu_torch.parallel import (
    create_mesh, reference_attention, ring_attention,
)

# the module (the package exports a function of the same name)
jring = importlib.import_module("generativeaiexamples_tpu.parallel.ring_attention")

# (seq shards, B, T, Hq, Hkv, D): JAX's two cases
CASES = [(8, 2, 32, 4, 4, 8), (4, 1, 16, 4, 2, 8)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, T, Hq, Hkv, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, D)).astype(dtype),
            rng.standard_normal((B, T, Hkv, D)).astype(dtype),
            rng.standard_normal((B, T, Hkv, D)).astype(dtype))


def _mesh(n):
    return create_mesh(1, 1, n, devices=["cpu"] * n)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES, ids=["seq8", "gqa_seq4"])
def test_ring_attention_matches_jax_s(case, causal):
    n, B, T, Hq, Hkv, D = case
    q, k, v = _inputs(B, T, Hq, Hkv, D)
    jmesh = jcreate_mesh(tensor_parallelism=1, data_parallelism=1, seq_parallelism=n)
    with jax.set_mesh(jmesh):
        want = np.asarray(jring.ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jmesh, axis_name="seq", causal=causal))
    got = ring_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         _mesh(n), axis_name="seq", causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, T, Hq, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and against both packages' one-device references
    ref = reference_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal)
    jref = np.asarray(jring.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                causal=causal))
    np.testing.assert_allclose(ref.numpy(), jref, **TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_a_bf16_ring_rounds_once_as_the_reference_does():
    """bf16 in, bf16 out: both compute in f32 and round once, so they
    differ by at most one bf16 ulp of the output."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(1, 64, 8, 2, 16, seed=3))
    got = ring_attention(q, k, v, _mesh(4))
    ref = reference_attention(q, k, v)
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs()
    assert float(err.max()) <= float(ref.float().abs().max()) * 2 ** -7


def test_each_hop_copies_the_blocks_even_on_one_device(monkeypatch):
    """P hops of K and V, each a copy to the next shard's device, even
    where the ring names one device more than once."""
    copies = []
    to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        if kwargs.get("copy"):
            copies.append(tuple(self.shape))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 2, 4))
    ring_attention(q, k, v, _mesh(4))
    assert copies == [(1, 4, 2, 4)] * (2 * 4 * 4)  # k and v, 4 shards, 4 hops


def test_the_ring_refuses_another_axis_and_an_uneven_cut():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 12, 2, 2, 4))
    with pytest.raises(ValueError, match="'seq' axis"):
        ring_attention(q, k, v, _mesh(2), axis_name="model")
    with pytest.raises(ValueError, match="not divisible by 8 seq shards"):
        ring_attention(q, k, v, _mesh(8))
