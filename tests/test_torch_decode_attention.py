"""Fixed-layout decode attention: the port's plain version (what its CUDA
wrapper runs on CPU tensors) against the JAX package's Pallas kernel in
interpret mode, the port's ``decode_attention_xla`` against JAX's, the
``supported`` predicate, and the kernel's cost count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.ops import decode_attention as jda
from generativeaiexamples_tpu_torch.models.convert import to_tensor
from generativeaiexamples_tpu_torch.ops import decode_attention as tda
from generativeaiexamples_tpu_torch.utils import hardware

B, Hq, Hkv, S, Dh = 4, 8, 4, 512, 128
# The Pallas kernel rounds p * v_scale to bf16 before its P.V dot, and both
# sides round the output to bf16; |out| < ~1 (convex mixes of rows of
# |v| <= 127 * 0.02), so they agree within a few bf16 steps: 0.02, as the
# page-attention comparison.
ATOL = 0.02


def _cache(rng, B=B, Hkv=Hkv, S=S, Dh=Dh):
    """An int8 head-major cache with scales, as tests/test_decode_attention.py draws it."""
    kq = rng.integers(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, Hkv, S, Dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (B, Hkv, 1, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (B, Hkv, 1, S)).astype(np.float32)
    return kq, ks, vq, vs


@pytest.mark.parametrize(
    "positions",
    [
        [0, 17, 255, S - 1],  # a dead slot at 0, mid-block, block edge, full capacity
        [300, 0, S - 1, 128],  # another order, a slot past the first block
        [S + 40, 5, 0, 511],  # a position past capacity clamps to S - 1
    ],
)
def test_plain_matches_pallas_interpret(positions):
    rng = np.random.default_rng(sum(positions))
    q = jnp.asarray(rng.standard_normal((B, Hq, Dh)), jnp.bfloat16)
    kq, ks, vq, vs = _cache(rng)
    pos = np.asarray(positions, np.int32)
    ref = jda.decode_attention(
        q, jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(pos),
        interpret=True,
    )
    out = tda.decode_attention(
        to_tensor(np.asarray(q)), *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
        torch.from_numpy(pos),
    )
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, Hq, Dh)
    assert bool(torch.isfinite(out.float()).all())
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=ATOL)


def test_plain_matches_pallas_interpret_on_the_kernels_split_edges():
    """Slots ending on a split's last row and on the next split's first, on
    a 64-row tile edge, and at the strip's last row, over a strip of three
    splits of the CUDA kernel (the Pallas kernel walks it in blocks of 256)."""
    st = tda.SPLIT_ROWS
    S2 = 3 * st
    rng = np.random.default_rng(21)
    q = jnp.asarray(rng.standard_normal((B, Hq, Dh)), jnp.bfloat16)
    kq, ks, vq, vs = _cache(rng, S=S2)
    for positions in ([st - 1, st, 2 * st - 1, 2 * st], [st + 63, st + 64, S2 - 1, 0]):
        pos = np.asarray(positions, np.int32)
        ref = jda.decode_attention(
            q, jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
            jnp.asarray(pos), interpret=True,
        )
        out = tda.decode_attention(
            to_tensor(np.asarray(q)), *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
            torch.from_numpy(pos),
        )
        np.testing.assert_allclose(
            out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=ATOL)


@pytest.mark.parametrize("S_,splits", [(1, 1), (511, 1), (512, 1), (513, 2), (8192, 16)])
def test_split_plan_covers_the_strip_from_its_shape_alone(S_, splits):
    rows, n = tda.split_plan(S_)
    assert (rows, n) == (tda.SPLIT_ROWS, splits)
    assert (n - 1) * rows < S_ <= n * rows
    # one split writes the output directly: no merge workspace
    ws = tda.workspace_elements(8, 32, 128, n)
    assert ws == (0 if n == 1 else 8 * 32 * n * (128 + 2))


def test_split_plan_refuses_an_empty_strip():
    with pytest.raises(ValueError, match="positive"):
        tda.split_plan(0)


def test_plain_reads_no_row_past_a_slots_position():
    """Rows past each slot's position must not change its output."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Dh)).astype(np.float32)).to(torch.bfloat16)
    kq, ks, vq, vs = (torch.from_numpy(a) for a in _cache(rng))
    pos = torch.tensor([3, 100, 0, 200], dtype=torch.int32)
    base = tda.decode_attention(q, kq, ks, vq, vs, pos)
    k2, v2, s2 = kq.clone(), vq.clone(), ks.clone()
    for b, p in enumerate(pos.tolist()):
        k2[b, :, p + 1:] = 127
        v2[b, :, p + 1:] = -127
        s2[b, :, 0, p + 1:] = 1e4
    torch.testing.assert_close(tda.decode_attention(q, k2, s2, v2, vs, pos), base, rtol=0, atol=0)


def test_plain_gives_zero_for_a_slot_with_no_live_row():
    """A negative position leaves no live row: l == 0 gives 0, as the
    Pallas kernel's _finish guards."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, Hq, Dh)).astype(np.float32)).to(torch.bfloat16)
    kq, ks, vq, vs = (torch.from_numpy(a) for a in _cache(rng, B=2))
    out = tda.decode_attention_plain(q, kq, ks, vq, vs, torch.tensor([-1, 4]))
    assert float(out[0].float().abs().max()) == 0.0
    assert float(out[1].float().abs().max()) > 0.0


@pytest.mark.parametrize("T,window", [(1, None), (1, 256), (3, 128), (3, None)])
def test_xla_read_matches_jax(T, window):
    """The same f32 formula on both sides, one rounding to bf16: equal up to
    one bf16 ulp (2^-7 of the value, ~f32 summation order)."""
    rng = np.random.default_rng(10 + T)
    q = jnp.asarray(rng.standard_normal((B, T, Hq, Dh)), jnp.bfloat16)
    kq, ks, vq, vs = _cache(rng)
    top = (window or S) - T
    pos = np.stack([np.minimum(np.asarray([0, 40, 100, top]) + t, (window or S) - 1)
                    for t in range(T)], axis=1).astype(np.int32)  # [B, T]
    ref = np.asarray(jda.decode_attention_xla(
        q, jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs), jnp.asarray(pos),
        window=window,
    ), np.float32)
    out = tda.decode_attention_xla(
        to_tensor(np.asarray(q)), *(torch.from_numpy(a) for a in (kq, ks, vq, vs)),
        torch.from_numpy(pos), window=window,
    )
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, T, Hq, Dh)
    diff = np.abs(out.float().numpy() - ref)
    assert (diff <= 2.0 ** -7 * np.abs(ref) + 1e-30).all(), float(diff.max())


def test_xla_read_agrees_with_the_plain_kernel_function():
    """With a window covering every position, the non-kernel read and the
    kernel's function agree to f32 rounding (both one bf16 rounding)."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((B, Hq, Dh)).astype(np.float32)).to(torch.bfloat16)
    kq, ks, vq, vs = (torch.from_numpy(a) for a in _cache(rng))
    pos = torch.tensor([0, 9, 300, S - 1], dtype=torch.int32)
    plain = tda.decode_attention_plain(q, kq, ks, vq, vs, pos)
    xla = tda.decode_attention_xla(q[:, None], kq, ks, vq, vs, pos[:, None])[:, 0]
    torch.testing.assert_close(plain.float(), xla.float(), rtol=0, atol=2.0 ** -7)


GEOMETRIES = [
    # (S, head_dim, heads, kv_heads), as the JAX package's tests use them
    (8192, 128, 32, 8),  # llama3-8b, the engine's default capacity
    (8192, 128, 64, 8),  # llama3-70b
    (512, 128, 8, 4),  # tests/test_decode_attention.py
    (128, 128, 64, 8),  # kernel-8dev
    (1024, 128, 32, 6),  # heads not divisible by kv heads
]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_supported_agrees_with_jax_where_the_tpu_tiling_holds(geom):
    assert tda.supported(*geom) == jda.supported(*geom)


def test_supported_drops_the_tpu_tiling_rules_only():
    # the TPU's lane/sublane rules refuse these; the CUDA kernel serves them
    assert tda.supported(8192, 64, 32, 8) and not jda.supported(8192, 64, 32, 8)
    assert tda.supported(100, 128, 32, 8) and not jda.supported(100, 128, 32, 8)
    assert tda.supported(128, 128, 4, 2) and not jda.supported(128, 128, 4, 2)
    # head dims the .cu is not instantiated for, and GQA that does not divide
    assert not tda.supported(128, 16, 4, 2)  # the debug preset
    assert not tda.supported(128, 96, 32, 8)
    assert not tda.supported(128, 128, 32, 6) and not jda.supported(128, 128, 32, 6)


def test_decode_attention_cost_counts_by_hand():
    """Two slots, S = 8, Hq = 4, Hkv = 2, Dh = 16: a slot at position 3
    (4 live rows) and one past capacity (clamped to 8 rows)."""
    nbytes, flops = hardware.decode_attention_cost([3, 12], 4, 2, 16, S=8)
    live = 4 + 8
    q_out = 2 * (2 * 4 * 16 * 2)  # per slot: q read + out written, bf16
    kv = 2 * live * 2 * (16 * 1 + 4)  # K and V rows of 16 int8 + one f32 scale, 2 heads
    assert nbytes == q_out + kv + 2 * 4  # + one int32 position per slot
    assert flops == 4 * 16 * 4 * live
    # unclamped without S; a bf16 cache without scales
    assert hardware.decode_attention_cost([12], 4, 2, 16)[1] == 4 * 16 * 4 * 13
    b16, _ = hardware.decode_attention_cost([3], 4, 2, 16, kv_bytes=2, scale_bytes=0)
    assert b16 == 2 * 4 * 16 * 2 + 2 * 4 * 2 * 32 + 4
