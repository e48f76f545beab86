"""The port's Llama serving path against the JAX package's, on the same
weights (carried over with params_from_jax) and the same inputs: monolithic
prefill (einsum and flash), the page-pool writes, chunked prefill over the
pool, and several decode steps (gather read and page-kernel read; the JAX
side runs its Pallas page kernel in interpret mode).

Tolerances. Dense float32 weights: both sides run the same f32 math and
differ only in summation order, so logits agree to ~1e-5 of their O(1)
size (ATOL_DENSE = 2e-4). int8 weights: the port runs the int8 kernel's
formula at decode shapes (bf16 activation, f32 sum, scale after the sum,
bf16 output) where the JAX package on the CPU runs ``int8_matmul_xla``
(bf16-rounded weights, f32 activation and output): two extra bf16
roundings per projection, ~2^-8 relative each, through two layers and
the head (ATOL_INT8 = 0.1). The JAX page kernel reads the pool as bf16
and rounds its probabilities to bf16 even for f32 pools, where the port's
plain read stays f32: with dense weights the kernel-read decode steps get
the bf16 bound (ATOL_BF16_READ = 5e-2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.models import llama as jl
from generativeaiexamples_tpu.ops import quant as jquant
from generativeaiexamples_tpu_torch.models import llama as tl
from generativeaiexamples_tpu_torch.models.convert import params_from_jax

CFG_J = jl.PRESETS["debug"]
CFG_T = tl.PRESETS["debug"]
PAGE = 8
PMAX = CFG_J.max_seq_len // PAGE
POOL = 1 + 3 * PMAX
ATOL_DENSE = 2e-4
ATOL_INT8 = 0.1
ATOL_BF16_READ = 5e-2
LENGTHS = [11, 24]
T = 24


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def test_presets_are_copied_exactly():
    assert tl.PRESETS.keys() == jl.PRESETS.keys()
    for name, cfg in jl.PRESETS.items():
        assert tl.PRESETS[name].__dict__ == cfg.__dict__, name
    assert tl.init_spec(CFG_T) == jl.init_spec(CFG_J)
    assert tl.count_logical_params(tl.PRESETS["llama3-8b"]) == jl.count_logical_params(
        jl.PRESETS["llama3-8b"]
    )


@pytest.fixture(scope="module", params=["dense", "int8"])
def weights(request):
    """(JAX layered params, port params, tolerance)."""
    stacked = jl.init_params(CFG_J, jax.random.PRNGKey(0), jnp.float32)
    if request.param == "int8":
        stacked = jquant.quantize_params_int8(stacked)
    port = params_from_jax(stacked)
    jparams = jl.consume_split_params_layers(stacked)
    return jparams, port, ATOL_INT8 if request.param == "int8" else ATOL_DENSE


def test_params_from_jax_takes_stacked_and_layered_trees():
    stacked = jquant.quantize_params_int8(jl.init_params(CFG_J, jax.random.PRNGKey(1), jnp.bfloat16))
    from_stacked = params_from_jax(stacked)
    from_layered = params_from_jax(jl.consume_split_params_layers(stacked))
    assert len(from_stacked["layers"]) == len(from_layered["layers"]) == CFG_J.num_layers
    for a, b in zip(from_stacked["layers"], from_layered["layers"]):
        assert sorted(a) == sorted(b)
        for key, val in a.items():
            pairs = [(val["q"], b[key]["q"]), (val["scale"], b[key]["scale"])] if isinstance(val, dict) else [(val, b[key])]
            for x, y in pairs:
                assert x.dtype == y.dtype and torch.equal(x, y), key
    assert from_stacked["embed"].dtype == torch.bfloat16  # bit-exact through uint16
    np.testing.assert_array_equal(
        from_stacked["embed"].view(torch.int16).numpy(),
        np.asarray(jl.init_params(CFG_J, jax.random.PRNGKey(1), jnp.bfloat16)["embed"]).view(np.int16),
    )


def _prompts():
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENGTHS), T), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rng.integers(0, CFG_J.vocab_size, n)
    return tokens, np.asarray(LENGTHS, np.int32)


def _tables():
    """Rows 0 and 1 own disjoint pages; row 2 is dead (all scratch)."""
    tables = np.zeros((3, PMAX), np.int32)
    tables[0] = 1 + np.arange(PMAX)
    tables[1] = 1 + PMAX + np.arange(PMAX)
    return tables


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
def test_prefill_layers(weights, use_flash):
    jparams, port, atol = weights
    tokens, lengths = _prompts()
    ref, ref_kvs = jl.prefill_layers(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(lengths),
        use_flash=use_flash, interpret=True,
    )
    out, kvs = tl.prefill_layers(
        port, CFG_T, torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(),
        use_flash=use_flash,
    )
    assert tuple(out.shape) == (2, CFG_T.vocab_size) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=atol)
    for (k, v), (rk, rv) in zip(kvs, ref_kvs):
        np.testing.assert_allclose(_np(k), _np(rk), rtol=0, atol=atol)
        np.testing.assert_allclose(_np(v), _np(rv), rtol=0, atol=atol)


def _prefilled(jparams, port):
    """Both pools after a monolithic prefill of the two prompts."""
    tokens, lengths = _prompts()
    tables = _tables()
    rows = tables[:2]
    jlogits, jkvs = jl.prefill_layers(jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(lengths), use_flash=False)
    jpool = jl.write_prefill_pages(
        jl.init_kv_pool(CFG_J, POOL, PAGE, jnp.float32), jkvs, jnp.asarray(rows), PAGE
    )
    tlogits, tkvs = tl.prefill_layers(port, CFG_T, torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(), use_flash=False)
    tpool = tl.init_kv_pool(CFG_T, POOL, PAGE, torch.float32)
    assert tl.write_prefill_pages(tpool, tkvs, torch.from_numpy(rows), PAGE) is tpool  # in place
    return jlogits, jpool, tlogits, tpool, tables


def _assert_pools(tpool, jpool, atol):
    for tc, jc in zip(tpool, jpool):
        np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), rtol=0, atol=atol)
        np.testing.assert_allclose(_np(tc["v"]), _np(jc["v"]), rtol=0, atol=atol)


def test_write_prefill_pages(weights):
    jparams, port, atol = weights
    _, jpool, _, tpool, _ = _prefilled(jparams, port)
    _assert_pools(tpool, jpool, atol)
    # row 0's prompt (11 tokens) landed on its first two pages, nothing
    # on pages no row owns
    assert float(tpool[0]["k"][1].abs().sum()) > 0
    assert float(tpool[0]["k"][2 * PMAX + 1:].abs().sum()) == 0


@pytest.mark.parametrize("page_kernel", [False, True], ids=["gather", "kernel"])
def test_decode_layers_paged_steps(weights, page_kernel):
    jparams, port, atol = weights
    if page_kernel:
        atol = max(atol, ATOL_BF16_READ)
    jlogits, jpool, tlogits, tpool, tables = _prefilled(jparams, port)
    positions = np.asarray(LENGTHS + [0], np.int32)
    live = np.asarray([True, True, False])
    nxt = np.concatenate([np.asarray(jnp.argmax(jlogits, -1), np.int32), [0]]).astype(np.int32)
    for _ in range(4):
        ref, jpool = jl.decode_layers_paged(
            jparams, CFG_J, jnp.asarray(nxt), jnp.asarray(positions), jnp.asarray(live),
            jnp.asarray(tables), jpool, window=CFG_J.max_seq_len, page_size=PAGE,
            page_kernel="interpret" if page_kernel else None,
        )
        out, _ = tl.decode_layers_paged(
            port, CFG_T, torch.from_numpy(nxt).long(), torch.from_numpy(positions).long(),
            torch.from_numpy(live), torch.from_numpy(tables), tpool,
            window=CFG_T.max_seq_len, page_size=PAGE, page_kernel=page_kernel,
        )
        np.testing.assert_allclose(_np(out)[:2], _np(ref)[:2], rtol=0, atol=atol)
        assert bool(torch.isfinite(out).all())  # the dead row too
        nxt = np.array(jnp.argmax(ref, -1), np.int32)
        positions = positions + live
    # pages of live rows match; the dead row wrote only the scratch page
    for tc, jc in zip(tpool, jpool):
        np.testing.assert_allclose(_np(tc["k"])[1:], _np(jc["k"])[1:], rtol=0, atol=atol)


def test_extend_layers_paged_chunks(weights):
    """A 20-token prompt prefilled in chunks of 8 on slot 1, next to a
    dead row (valid = 0, writes only the scratch page)."""
    jparams, port, atol = weights
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, CFG_J.vocab_size, 20).astype(np.int32)
    tables = _tables()
    C, n = 8, len(prompt)
    jpool = jl.init_kv_pool(CFG_J, POOL, PAGE, jnp.float32)
    tpool = tl.init_kv_pool(CFG_T, POOL, PAGE, torch.float32)
    slots = np.asarray([1, 2], np.int32)
    for k in range(-(-n // C)):
        tok = np.zeros((2, C), np.int32)
        seg = prompt[k * C:(k + 1) * C]
        tok[0, : len(seg)] = seg
        valid = np.asarray([min(C, max(0, n - k * C)), 0], np.int32)
        offsets = np.asarray([k * C, 0], np.int32)
        window = 32
        ref_h, jpool = jl.extend_layers_paged(
            jparams, CFG_J, jnp.asarray(tok), jnp.asarray(offsets), jnp.asarray(valid),
            jnp.asarray(slots), jnp.asarray(tables), jpool, window, PAGE,
        )
        out_h, _ = tl.extend_layers_paged(
            port, CFG_T, torch.from_numpy(tok).long(), torch.from_numpy(offsets).long(),
            torch.from_numpy(valid).long(), torch.from_numpy(slots).long(),
            torch.from_numpy(tables), tpool, window, PAGE,
        )
        np.testing.assert_allclose(_np(out_h)[0], _np(ref_h)[0], rtol=0, atol=atol)
    for tc, jc in zip(tpool, jpool):
        np.testing.assert_allclose(_np(tc["k"])[1:], _np(jc["k"])[1:], rtol=0, atol=atol)
    # the chunked prompt's last hidden state gives the monolithic prefill's logits
    logits = tl._head(port, out_h[:1, None, :], CFG_T)[:, 0, :]
    mono, _ = tl.prefill_layers(
        port, CFG_T, torch.from_numpy(prompt[None]).long(), torch.tensor([n]), use_flash=False
    )
    np.testing.assert_allclose(_np(logits), _np(mono), rtol=0, atol=atol)
