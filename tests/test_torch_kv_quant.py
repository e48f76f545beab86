"""Quantized KV pools (int8 and int4), port against the JAX package: the
row codecs bit for bit, then the paged model functions that write and read
them (``write_prefill_pages``, ``extend_layers_paged``,
``decode_layers_paged``) on the debug preset (2 layers), same weights and
inputs on both sides.

Two weight sets:
- ``w8a8``: int8 packs with per-token int8 activations (the JAX side's
  CPU mode ``w8a8_xla``, the port's ``w8a8``). Every product is an exact
  integer sum and the activation quantization absorbs the last-ulp
  differences of the f32 norms and rotary embedding, so the pools after
  the writes are bitwise JAX's and the gathered-read logits agree to f32
  summation order (ATOL_EXACT).
- ``dense``: float32 weights. The two packages' f32 matmuls sum in
  different orders, so K/V rows differ in their last ulp before they are
  quantized: a scale may differ by an ulp (rtol 1e-5) and an integer by
  one step where its rounding sat on a half. Logits agree within
  ATOL_DENSE, as for the bf16 pool (tests/test_torch_llama.py).

The decode read through the page kernel (JAX's Pallas kernel in interpret
mode against the port's plain version) rounds probabilities times V
scales to bf16 on the JAX side only (2^-8 relative on the attention
output); with w8a8 weights the next projection's per-token int8
quantization turns such a shift into a whole step (1/127 of the row's
absmax) wherever a rounding flips, so those logits (|logit| < ~3) get
ATOL_KERNEL_READ = 0.25, and only layer 0's rows, which depend on the
tokens alone, stay exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.convert import params_from_jax, to_tensor

CFG_J = jl.PRESETS["debug"]
CFG_T = tl.PRESETS["debug"]
PAGE = 8
PMAX = CFG_J.max_seq_len // PAGE
POOL = 1 + 3 * PMAX
LENGTHS = [11, 24]
T = 24
ATOL_EXACT = 1e-5
ATOL_DENSE = 2e-4
ATOL_KERNEL_READ = 0.25
KV_DTYPES = ["int8", "int4"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# --------------------------------------------------------------------- #
# row codecs


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_row_codecs_bitwise_equal_to_jax(kv_dtype, dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((5, 7, 3, 16)) * 2, dtype)
    x = x.at[0, 0, 0].set(0)  # an all-zero row takes the 1e-8 floor
    jfn, tfn = {
        "int8": (jl.quantize_kv, tl.quantize_kv),
        "int4": (jl.quantize_kv_int4, tl.quantize_kv_int4),
    }[kv_dtype]
    ref_q, ref_s = jfn(x)
    q, s = tfn(to_tensor(np.asarray(x)))
    assert q.dtype == (torch.int8 if kv_dtype == "int8" else torch.uint8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def test_unpack_int4_bitwise_equal_to_jax_on_every_byte():
    u = np.arange(256, dtype=np.uint8).reshape(8, 32)
    out = tl.unpack_int4(torch.from_numpy(u))
    assert out.dtype == torch.int8 and tuple(out.shape) == (8, 64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jl.unpack_int4(jnp.asarray(u))))


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_init_kv_pool_matches_jax_layout(kv_dtype):
    packed = kv_dtype == "int4"
    ref = jl.init_kv_pool(CFG_J, 5, PAGE, quantized=True, packed=packed)
    mine = tl.init_kv_pool(CFG_T, 5, PAGE, quantized=True, packed=packed)
    assert len(mine) == len(ref) == CFG_T.num_layers
    for m, r in zip(mine, ref):
        assert sorted(m) == sorted(r) == ["k", "ks", "v", "vs"]
        for name in m:
            assert tuple(m[name].shape) == r[name].shape, name
            assert str(m[name].dtype).split(".")[-1] == str(r[name].dtype), name


# --------------------------------------------------------------------- #
# model level


@pytest.fixture(scope="module", params=["w8a8", "dense"])
def weights(request):
    """(JAX layered params, JAX quant mode, port params, port quant mode,
    exact): the same f32 weights on both sides."""
    stacked = jl.init_params(CFG_J, jax.random.PRNGKey(0), jnp.float32)
    if request.param == "w8a8":
        stacked = jquant.quantize_params_int8(stacked)
        modes = ("w8a8_xla", "w8a8")
    else:
        modes = (None, None)
    port = params_from_jax(stacked)  # before the JAX split consumes the stacked tree
    return (jl.consume_split_params_layers(stacked), modes[0], port, modes[1],
            request.param == "w8a8")


def _tables():
    """Rows 0 and 1 own disjoint pages; row 2 is dead (all scratch)."""
    tables = np.zeros((3, PMAX), np.int32)
    tables[0] = 1 + np.arange(PMAX)
    tables[1] = 1 + PMAX + np.arange(PMAX)
    return tables


def _assert_pools(tpool, jpool, exact, first_page=1):
    """Pools equal bit for bit, or, for dense weights, scales within an
    ulp's relative size and integers within one quantization step."""
    for tc, jc in zip(tpool, jpool):
        for name in ("k", "v", "ks", "vs"):
            mine, ref = tc[name][first_page:], jnp.asarray(jc[name])[first_page:]
            if exact:
                np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=name)
            elif name in ("ks", "vs"):
                np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5, atol=0)
            else:
                if mine.dtype == torch.uint8:
                    mine, ref = tl.unpack_int4(mine), jl.unpack_int4(ref)
                diff = np.abs(mine.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32))
                assert diff.max() <= 1, name


def _prefilled(weights, kv_dtype):
    """Both quantized pools after a monolithic prefill of two prompts."""
    jparams, jqk, port, tqk, _ = weights
    packed = kv_dtype == "int4"
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENGTHS), T), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rng.integers(0, CFG_J.vocab_size, n)
    lengths = np.asarray(LENGTHS, np.int32)
    rows = _tables()[:2]
    jlogits, jkvs = jl.prefill_layers(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(lengths), use_flash=False, quant_kernel=jqk
    )
    jpool = jl.write_prefill_pages(
        jl.init_kv_pool(CFG_J, POOL, PAGE, jnp.float32, quantized=True, packed=packed),
        jkvs, jnp.asarray(rows), PAGE,
    )
    tlogits, tkvs = tl.prefill_layers(
        port, CFG_T, torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(),
        use_flash=False, quant_kernel=tqk,
    )
    tpool = tl.init_kv_pool(CFG_T, POOL, PAGE, torch.float32, quantized=True, packed=packed)
    assert tl.write_prefill_pages(tpool, tkvs, torch.from_numpy(rows), PAGE) is tpool  # in place
    return jlogits, jpool, tlogits, tpool


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_write_prefill_pages_quantized(weights, kv_dtype):
    exact = weights[4]
    jlogits, jpool, tlogits, tpool = _prefilled(weights, kv_dtype)
    np.testing.assert_allclose(
        _np(tlogits), _np(jlogits), rtol=0, atol=ATOL_EXACT if exact else ATOL_DENSE
    )
    _assert_pools(tpool, jpool, exact, first_page=0)
    assert float(tpool[0]["ks"][1].abs().sum()) > 0  # row 0's prompt landed


@pytest.mark.parametrize("page_kernel", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_decode_layers_paged_quantized(weights, kv_dtype, page_kernel):
    jparams, jqk, port, tqk, exact = weights
    jlogits, jpool, _, tpool = _prefilled(weights, kv_dtype)
    tables = _tables()
    positions = np.asarray(LENGTHS + [0], np.int32)
    live = np.asarray([True, True, False])
    nxt = np.concatenate([np.asarray(jnp.argmax(jlogits, -1), np.int32), [0]]).astype(np.int32)
    atol = ATOL_KERNEL_READ if page_kernel else (ATOL_EXACT if exact else ATOL_DENSE)
    for _ in range(4):
        ref, jpool = jl.decode_layers_paged(
            jparams, CFG_J, jnp.asarray(nxt), jnp.asarray(positions), jnp.asarray(live),
            jnp.asarray(tables), jpool, window=CFG_J.max_seq_len, page_size=PAGE,
            quant_kernel=jqk, page_kernel="interpret" if page_kernel else None,
        )
        out, _ = tl.decode_layers_paged(
            port, CFG_T, torch.from_numpy(nxt).long(), torch.from_numpy(positions).long(),
            torch.from_numpy(live), torch.from_numpy(tables), tpool,
            window=CFG_T.max_seq_len, page_size=PAGE, quant_kernel=tqk, page_kernel=page_kernel,
        )
        np.testing.assert_allclose(_np(out)[:2], _np(ref)[:2], rtol=0, atol=atol)
        assert bool(torch.isfinite(out).all())  # the dead row too
        nxt = np.array(jnp.argmax(ref, -1), np.int32)
        positions = positions + live
    # the dead row wrote only the scratch page, skipped here
    if page_kernel:
        _assert_pools(tpool[:1], jpool[:1], exact)
    else:
        _assert_pools(tpool, jpool, exact)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_extend_layers_paged_quantized(weights, kv_dtype):
    """A 20-token prompt prefilled in chunks of 8 on slot 1, next to a
    dead row (valid = 0, writes only the scratch page)."""
    jparams, jqk, port, tqk, exact = weights
    packed = kv_dtype == "int4"
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG_J.vocab_size, 20).astype(np.int32)
    tables = _tables()
    C, n = 8, len(prompt)
    jpool = jl.init_kv_pool(CFG_J, POOL, PAGE, jnp.float32, quantized=True, packed=packed)
    tpool = tl.init_kv_pool(CFG_T, POOL, PAGE, torch.float32, quantized=True, packed=packed)
    slots = np.asarray([1, 2], np.int32)
    for k in range(-(-n // C)):
        tok = np.zeros((2, C), np.int32)
        seg = prompt[k * C:(k + 1) * C]
        tok[0, : len(seg)] = seg
        valid = np.asarray([min(C, max(0, n - k * C)), 0], np.int32)
        offsets = np.asarray([k * C, 0], np.int32)
        ref_h, jpool = jl.extend_layers_paged(
            jparams, CFG_J, jnp.asarray(tok), jnp.asarray(offsets), jnp.asarray(valid),
            jnp.asarray(slots), jnp.asarray(tables), jpool, 32, PAGE, quant_kernel=jqk,
        )
        out_h, _ = tl.extend_layers_paged(
            port, CFG_T, torch.from_numpy(tok).long(), torch.from_numpy(offsets).long(),
            torch.from_numpy(valid).long(), torch.from_numpy(slots).long(),
            torch.from_numpy(tables), tpool, 32, PAGE, quant_kernel=tqk,
        )
        np.testing.assert_allclose(
            _np(out_h)[0], _np(ref_h)[0], rtol=0, atol=ATOL_EXACT if exact else ATOL_DENSE
        )
    _assert_pools(tpool, jpool, exact)
    # the valid tokens were written, and only onto slot 1's pages
    assert float(tpool[0]["ks"][1 + PMAX].abs().min()) > 0
    assert float(tpool[0]["ks"][1:1 + PMAX].abs().sum()) == 0
