"""Ragged paged attention: the port's plain version (what its CUDA wrapper
runs on CPU tensors) against the Pallas kernel in interpret mode, over
the ragged page tables of tests/test_page_attention.py (dead row, one-page
row, mid-length row, full row, multi-query chunks), plus the two
``supports_geometry`` predicates."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import page_attention as jpa
from generativeaiexamples_tpu_torch.models.convert import to_tensor
from generativeaiexamples_tpu_torch.ops import page_attention as tpa

B, Hq, Hkv, Dh = 3, 4, 2, 16
PAGE, PMAX, POOL = 8, 8, 24
S = PMAX * PAGE
# The Pallas kernel rounds probabilities to bf16 before P.V and both round
# the output to bf16; |out| < ~2 (mixes of N(0, 1) rows), so the results
# agree within a few bf16 steps: the repo's own kernel test uses 0.02.
ATOL = 0.02


def _tables():
    tables = np.zeros((B, PMAX), np.int32)
    tables[0, :1] = [1]
    tables[1, :4] = [2, 3, 4, 5]
    tables[2, :] = np.arange(6, 6 + PMAX)
    return tables


def _case(seed, T, positions):
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((POOL, PAGE, Hkv, Dh)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((POOL, PAGE, Hkv, Dh)), jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, T, Hq, Dh)), jnp.bfloat16)
    tables = _tables()
    pos = np.asarray(positions, np.int32)
    ref = jpa.paged_attention(q, k, v, jnp.asarray(tables), jnp.asarray(pos), interpret=True)
    out = tpa.paged_attention(
        *(to_tensor(np.asarray(a)) for a in (q, k, v)),
        torch.from_numpy(tables), torch.from_numpy(pos),
    )
    return out, np.asarray(ref, np.float32)


@pytest.mark.parametrize(
    "T,positions",
    [
        (1, [3, 25, S - 1]),  # one-page row, mid-length row, full-capacity row
        (1, [0, 0, 40]),  # a dead row (position 0 on the scratch page)
        (3, [2, 20, S - 3]),  # multi-query rows: query t attends <= pos + t
    ],
)
def test_plain_matches_pallas_interpret(T, positions):
    out, ref = _case(T, T, positions)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, T, Hq, Dh)
    assert bool(torch.isfinite(out.float()).all())
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=ATOL)


def test_rows_ignore_pages_past_their_last_live_token():
    """Garbage in pages a row has not reached must not change its output."""
    rng = np.random.default_rng(9)
    k = torch.from_numpy(rng.standard_normal((POOL, PAGE, Hkv, Dh)).astype(np.float32)).to(torch.bfloat16)
    v = k.clone()
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)).to(torch.bfloat16)
    tables = torch.from_numpy(_tables())
    pos = torch.tensor([3, 25, 30], dtype=torch.int32)
    base = tpa.paged_attention(q, k, v, tables, pos)
    k2, v2 = k.clone(), v.clone()
    k2[10:] = 1e4  # row 2 logical pages 4.. (physical 10..) hold tokens > 31
    v2[10:] = 1e4
    torch.testing.assert_close(tpa.paged_attention(q, k2, v2, tables, pos), base)


GEOMETRIES = [
    # (page, head_dim, heads, kv_heads, query_len)
    (128, 128, 32, 8, 1),  # llama3-8b decode
    (128, 128, 64, 8, 1),  # llama3-70b decode
    (8, 128, 64, 8, 1),  # kernel-8dev
    (128, 128, 32, 8, 5),  # short multi-query chunk
    (128, 128, 32, 8, 16),  # 512 query rows: the cap
    (128, 128, 32, 8, 17),  # over the cap (prefill-length chunks)
    (128, 128, 32, 6, 1),  # heads not divisible by kv heads
    (64, 256, 16, 8, 1),
]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_supports_geometry_agrees_with_jax(geom):
    page, dh, hq, hkv, t = geom
    assert tpa.supports_geometry(page, dh, hq, hkv, query_len=t) == jpa.supports_geometry(
        page, dh, hq, hkv, query_len=t
    )


def test_supports_geometry_serves_bf16_pools_only():
    assert tpa.supports_geometry(128, 128, 32, 8)
    assert not tpa.supports_geometry(128, 128, 32, 8, kv_dtype="int8")
    assert not tpa.supports_geometry(128, 128, 32, 8, kv_dtype="int4")
    # a head dim the CUDA kernel is not instantiated for
    assert not tpa.supports_geometry(8, 16, 4, 2)
    assert tpa.MAX_QUERY_ROWS == jpa.MAX_QUERY_ROWS
