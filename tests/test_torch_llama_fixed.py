"""The fixed KV layout, port against the JAX package, on the debug preset
(2 layers) with the same weights and inputs on both sides: the per-slot
caches (f32 and head-major int8), the monolithic wave's slot write (inline
in the JAX engine, llm_engine.py:1992-2012, reproduced here in jnp), the
chunked ``extend_layers`` (a full chunk, then a partial one, beside a
``valid == 0`` row), ``decode_layers`` steps with a dead slot, and the port's fixed layout
against its paged layout.

Tolerances.
- Dense float32 weights: both sides run the same f32 math and differ only
  in summation order, so logits agree within ATOL (1e-4 of their O(1)
  size) and f32 caches within ATOL. An int8 cache row may sit one
  quantization step apart where a value's rounding sat on a half, and its
  scale an ulp apart (rtol 1e-5).
- w8a8 weights (JAX's CPU mode ``w8a8_xla``, the port's ``w8a8``): every
  product is an exact integer sum and the per-token activation quantization
  absorbs the last-ulp differences of the norms and rotary embedding, so
  int8 caches are bitwise equal (as for the paged pools,
  tests/test_torch_kv_quant.py) and logits agree within ATOL.
- The port's kernel read (``kv_kernel=True``, its plain version here)
  folds the scales after the integer dots where JAX's non-kernel read
  dequantizes first: f32 rounding, within ATOL on dense weights; under
  w8a8 a flipped activation rounding is a whole step (ATOL_KERNEL_READ,
  as tests/test_torch_kv_quant.py allows the page kernel's read).
- Fixed against paged in the port: the same rows in the same order and the
  same attention formula, so logits agree within 1e-5.
"""
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
S = CFG_J.max_seq_len
B = 3  # slots
ATOL = 1e-4
ATOL_LAYOUTS = 1e-5
ATOL_KERNEL_READ = 0.25
LENGTHS = [11, 24]  # the monolithic wave, on slots 0 and 2
WAVE_SLOTS = [0, 2]
T = 24
C = 16  # prefill chunk of the extend test
EXT_SLOT = 1


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=["dense", "w8a8"])
def weights(request):
    """(JAX layered params, JAX quant mode, port params, port quant mode,
    exact)."""
    stacked = jl.init_params(CFG_J, jax.random.PRNGKey(0), jnp.float32)
    modes = (None, None)
    if request.param == "w8a8":
        stacked = jquant.quantize_params_int8(stacked)
        modes = ("w8a8_xla", "w8a8")
    port = params_from_jax(stacked)  # before the JAX split consumes the stacked tree
    return (jl.consume_split_params_layers(stacked), modes[0], port, modes[1],
            request.param == "w8a8")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_init_kv_cache_layers_matches_jax_layout(quantized):
    ref = jl.init_kv_cache_layers(CFG_J, B, S, jnp.float32, quantized=quantized)
    mine = tl.init_kv_cache_layers(CFG_T, B, S, torch.float32, quantized=quantized)
    assert len(mine) == len(ref) == CFG_T.num_layers
    for m, r in zip(mine, ref):
        assert sorted(m) == sorted(r)
        for name in m:
            assert tuple(m[name].shape) == r[name].shape, name
            assert str(m[name].dtype).split(".")[-1] == str(r[name].dtype), name
            assert float(m[name].abs().sum()) == 0


def _jax_write_prefill_slots(caches, kvs, slots):
    """The JAX engine's monolithic slot write (llm_engine.py:1992-2012)."""
    N, T_ = kvs[0][0].shape[:2]
    Hkv = CFG_J.num_kv_heads
    new = []
    for c, (k, v) in zip(caches, kvs):
        if "ks" in c:
            kq, ksn = jl.quantize_kv(k)
            vq, vsn = jl.quantize_kv(v)
            s3 = slots[:, None, None]
            h3 = jnp.arange(Hkv, dtype=jnp.int32)[None, :, None]
            p3 = jnp.arange(T_, dtype=jnp.int32)[None, None, :]
            z3 = jnp.zeros_like(p3)
            new.append({
                "k": c["k"].at[s3, h3, p3].set(jnp.swapaxes(kq, 1, 2)),
                "v": c["v"].at[s3, h3, p3].set(jnp.swapaxes(vq, 1, 2)),
                "ks": c["ks"].at[s3, h3, z3, p3].set(jnp.swapaxes(ksn, 1, 2)),
                "vs": c["vs"].at[s3, h3, z3, p3].set(jnp.swapaxes(vsn, 1, 2)),
            })
        else:
            s1 = slots[:, None]
            pos = jnp.arange(T_, dtype=jnp.int32)[None, :]
            new.append({"k": c["k"].at[s1, pos].set(k.astype(c["k"].dtype)),
                        "v": c["v"].at[s1, pos].set(v.astype(c["v"].dtype))})
    return new


def _assert_caches(tcaches, jcaches, exact, atol=ATOL):
    for tc, jc in zip(tcaches, jcaches):
        for name in tc:
            mine, ref = tc[name].numpy(), np.asarray(jc[name])
            if name in ("ks", "vs"):
                if exact:
                    np.testing.assert_array_equal(mine, ref, err_msg=name)
                else:
                    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=0, err_msg=name)
            elif mine.dtype == np.int8:
                diff = np.abs(mine.astype(np.int32) - ref.astype(np.int32))
                assert diff.max() <= (0 if exact else 1), name
            else:
                np.testing.assert_allclose(mine, ref, rtol=0, atol=atol, err_msg=name)


def _prompts():
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(LENGTHS), T), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rng.integers(0, CFG_J.vocab_size, n)
    ext = rng.integers(0, CFG_J.vocab_size, 20).astype(np.int32)  # 16 + a partial 4
    return tokens, np.asarray(LENGTHS, np.int32), ext


def _prefilled(weights, quantized):
    """Both sides after the monolithic wave on slots 0 and 2, then a
    20-token prompt extended into slot 1 in chunks of 16 beside slot 0 as a
    ``valid == 0`` row. Returns the wave's logits, the extend's last hidden
    states and the caches of both sides."""
    jparams, jqk, port, tqk, exact = weights
    tokens, lengths, ext = _prompts()
    slots = np.asarray(WAVE_SLOTS, np.int32)
    jlogits, jkvs = jl.prefill_layers(
        jparams, CFG_J, jnp.asarray(tokens), jnp.asarray(lengths), use_flash=False, quant_kernel=jqk
    )
    jc = _jax_write_prefill_slots(
        jl.init_kv_cache_layers(CFG_J, B, S, jnp.float32, quantized=quantized), jkvs,
        jnp.asarray(slots),
    )
    tlogits, tkvs = tl.prefill_layers(
        port, CFG_T, torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(),
        use_flash=False, quant_kernel=tqk,
    )
    tc = tl.init_kv_cache_layers(CFG_T, B, S, torch.float32, quantized=quantized)
    assert tl.write_prefill_slots(tc, tkvs, torch.from_numpy(slots)) is tc  # in place
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), rtol=0, atol=ATOL)
    _assert_caches(tc, jc, exact)

    ext_h = []
    n = len(ext)
    ext_slots = np.asarray([EXT_SLOT, 0], np.int32)
    for k in range(-(-n // C)):
        tok = np.zeros((2, C), np.int32)
        seg = ext[k * C:(k + 1) * C]
        tok[0, : len(seg)] = seg
        tok[1] = 7  # the valid == 0 row's tokens must not land anywhere
        valid = np.asarray([len(seg), 0], np.int32)
        offsets = np.asarray([k * C, 0], np.int32)
        jh, jc = jl.extend_layers(
            jparams, CFG_J, jnp.asarray(tok), jnp.asarray(offsets), jnp.asarray(valid),
            jnp.asarray(ext_slots), jc, 32, quant_kernel=jqk,
        )
        th, _ = tl.extend_layers(
            port, CFG_T, torch.from_numpy(tok).long(), torch.from_numpy(offsets).long(),
            torch.from_numpy(valid).long(), torch.from_numpy(ext_slots).long(), tc, 32,
            quant_kernel=tqk,
        )
        np.testing.assert_allclose(_np(th)[0], _np(jh)[0], rtol=0, atol=ATOL)
        ext_h.append(th[:1])
    _assert_caches(tc, jc, exact)
    return jlogits, tlogits, ext_h, jc, tc


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_prefill_slots_and_chunked_extend(weights, quantized):
    c = _prefilled(weights, quantized)[4][0]

    def rows(slot):  # per-row magnitude of a slot's strip, [S]
        return c["ks"][slot, :, 0].sum(0) if quantized else c["k"][slot].abs().sum(dim=(-1, -2))

    # slot 0's wave rows survived the valid == 0 row's masked writes
    assert float(rows(0)[:11].min()) > 0
    # the extended prompt landed on slot 1's rows 0..19 only
    assert float(rows(1)[:20].min()) > 0 and float(rows(1)[20:].sum()) == 0


@pytest.mark.parametrize(
    "quantized,kv_kernel", [(False, False), (True, False), (True, True)],
    ids=["f32", "int8-xla", "int8-kernel"],
)
def test_decode_layers_steps(weights, quantized, kv_kernel):
    """4 decode steps over all three slots after the wave and the extend;
    slot 1 decodes, then dies (position 0) for the last two steps. The
    kernel read against JAX's non-kernel read: under w8a8 its f32 rounding
    becomes whole activation quantization steps where a rounding flips
    (ATOL_KERNEL_READ, and only layer 0's cache, which depends on the
    tokens alone, stays bitwise)."""
    jparams, jqk, port, tqk, exact = weights
    atol = ATOL_KERNEL_READ if (kv_kernel and exact) else ATOL
    jlogits, _, ext_h, jc, tc = _prefilled(weights, quantized)
    ext_first = int(torch.argmax(tl._head(port, ext_h[-1][:, None], CFG_T, tqk)[0, 0]))
    first = np.asarray(jnp.argmax(jlogits, -1), np.int32)
    nxt = np.asarray([first[0], ext_first, first[1]], np.int32)
    positions = np.asarray([LENGTHS[0], 20, LENGTHS[1]], np.int32)
    for step in range(4):
        if step == 2:  # slot 1 finished: dead slots decode at position 0
            positions[1] = 0
        ref, jc = jl.decode_layers(
            jparams, CFG_J, jnp.asarray(nxt), jnp.asarray(positions), jc, window=64,
            quant_kernel=jqk, kv_kernel=False,
        )
        out, _ = tl.decode_layers(
            port, CFG_T, torch.from_numpy(nxt).long(), torch.from_numpy(positions).long(), tc,
            window=64, quant_kernel=tqk, kv_kernel=kv_kernel,
        )
        assert bool(torch.isfinite(out).all())
        np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=atol)
        nxt = np.array(jnp.argmax(ref, -1), np.int32)
        positions = np.where(np.arange(B) == 1, positions, positions + 1).astype(np.int32)
        if step < 2:
            positions[1] += 1
    if kv_kernel and exact:
        _assert_caches(tc[:1], jc[:1], exact)
    else:
        _assert_caches(tc, jc, exact)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_decode_layers_reads_only_the_window(weights, quantized):
    """The engine narrows the non-kernel read to a window covering every
    slot's position (``_decode_window``): the logits of a step over the
    first 32 rows equal those over the whole strip, since the rows past a
    slot's position are masked either way."""
    _, _, port, tqk, _ = weights
    _, tlogits, _, _, tc = _prefilled(weights, quantized)
    tc2 = [{k: t.clone() for k, t in c.items()} for c in tc]
    first = torch.argmax(tlogits, -1)
    tokens = torch.stack([first[0], torch.tensor(0), first[1]])
    pos = torch.tensor([LENGTHS[0], 0, LENGTHS[1]])  # slot 1 dead at 0
    narrow, _ = tl.decode_layers(port, CFG_T, tokens, pos, tc, window=32, quant_kernel=tqk)
    full, _ = tl.decode_layers(port, CFG_T, tokens, pos, tc2, quant_kernel=tqk)
    np.testing.assert_allclose(_np(narrow), _np(full), rtol=0, atol=ATOL)
    _assert_caches(tc, tc2, exact=True, atol=0)


def test_decode_layers_gives_the_kernel_int32_positions_once(weights, monkeypatch):
    """The kernel read takes int32 positions; ``decode_layers`` casts the
    engine's int64 positions once per step, not once per layer."""
    _, _, port, tqk, _ = weights
    seen = []
    real = tl.decode_attention.decode_attention

    def spy(q, k_q, k_s, v_q, v_s, positions):
        seen.append(positions)
        return real(q, k_q, k_s, v_q, v_s, positions)

    monkeypatch.setattr(tl.decode_attention, "decode_attention", spy)
    tc = tl.init_kv_cache_layers(CFG_T, B, S, torch.float32, quantized=True)
    tl.decode_layers(port, CFG_T, torch.tensor([3, 4, 5]), torch.tensor([0, 7, 2]), tc,
                     quant_kernel=tqk, kv_kernel=True)
    assert len(seen) == CFG_T.num_layers
    assert all(p is seen[0] for p in seen) and seen[0].dtype == torch.int32
    assert seen[0].tolist() == [0, 7, 2]


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_fixed_and_paged_layouts_agree_in_the_port(weights, kv):
    """The same prompt through the port's two layouts: a monolithic 11-token
    prefill, a 20-token prompt in chunks of 16, and 4 decode steps of both
    rows."""
    _, _, port, tqk, _ = weights
    quantized = kv == "int8"
    page, pmax = 8, S // 8
    tokens, lengths, ext = _prompts()
    tables = torch.zeros((2, pmax), dtype=torch.int32)
    tables[0] = 1 + torch.arange(pmax)
    tables[1] = 1 + pmax + torch.arange(pmax)
    pool = tl.init_kv_pool(CFG_T, 1 + 2 * pmax, page, torch.float32, quantized=quantized)
    fixed = tl.init_kv_cache_layers(CFG_T, 2, S, torch.float32, quantized=quantized)
    logits, kvs = tl.prefill_layers(port, CFG_T, torch.from_numpy(tokens[:1, :11]).long(),
                                    torch.tensor([11]), use_flash=False, quant_kernel=tqk)
    tl.write_prefill_pages(pool, kvs, tables[:1], page)
    tl.write_prefill_slots(fixed, kvs, torch.tensor([0]))
    slots = torch.tensor([1])
    for k in range(2):
        seg = torch.from_numpy(ext[k * C:(k + 1) * C]).long()
        tok = torch.zeros((1, C), dtype=torch.long)
        tok[0, : len(seg)] = seg
        args = (tok, torch.tensor([k * C]), torch.tensor([len(seg)]), slots)
        hp, _ = tl.extend_layers_paged(port, CFG_T, *args, tables, pool, 32, page, quant_kernel=tqk)
        hf, _ = tl.extend_layers(port, CFG_T, *args, fixed, 32, quant_kernel=tqk)
        np.testing.assert_allclose(_np(hf), _np(hp), rtol=0, atol=ATOL_LAYOUTS)
    nxt = torch.stack([torch.argmax(logits[0]), torch.argmax(tl._head(port, hf[:, None], CFG_T, tqk)[0, 0])])
    pos = torch.tensor([11, 20])
    live = torch.ones(2, dtype=torch.bool)
    for _ in range(4):
        lp, _ = tl.decode_layers_paged(port, CFG_T, nxt, pos, live, tables, pool, window=64,
                                       page_size=page, quant_kernel=tqk)
        lf, _ = tl.decode_layers(port, CFG_T, nxt, pos, fixed, window=64, quant_kernel=tqk)
        np.testing.assert_allclose(_np(lf), _np(lp), rtol=0, atol=ATOL_LAYOUTS)
        nxt = torch.argmax(lp, -1)
        pos = pos + 1
