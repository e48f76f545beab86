"""The CUDA kernels against their plain PyTorch versions, on the card; and
the retrieval side (the BERT encoder, the embedder's two paths and its own
stream, exact and IVF search) on the card against the CPU and numpy.

These need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. The file
imports nothing of JAX, so it runs on the GPU machine on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels_on_card.py

(``--noconftest``: the repository's conftest sets up JAX's CPU platform.)
chip_smoke.py checks the same kernels at the llama3-8b shapes."""
import types

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import _build
from generativeaiexamples_tpu_torch.ops import decode_attention as da
from generativeaiexamples_tpu_torch.ops import flash_attention as fa
from generativeaiexamples_tpu_torch.ops import int8_matmul as im
from generativeaiexamples_tpu_torch.ops import page_attention as pa
from generativeaiexamples_tpu_torch.ops import quant


@pytest.fixture
def card():
    """The GPU, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def test_int8_matmul_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(0)
    for M, K, F in ((1, 200, 700), (8, 4096, 1024), (37, 1000, 512), (128, 384, 1536)):
        w = torch.randn((K, F), generator=gen, device=card) * 0.05
        packed = quant.quantize_int8(w)
        x = torch.randn((M, K), generator=gen, device=card).to(torch.bfloat16)
        before = im.int8_matmul.launches
        y = im.int8_matmul(x, packed["q"], packed["scale"])
        assert im.int8_matmul.launches == before + 1
        ref = im.int8_matmul_plain(x, packed["q"], packed["scale"])
        # f32 sums in another order: within one bf16 step of the largest output
        torch.testing.assert_close(y.float(), ref.float(), rtol=0, atol=2.0**-7 * float(ref.abs().max()))


@pytest.mark.parametrize("M", [1, 4, 8, 16, 128])
def test_int8_matmul_tensor_core_tiles_match_plain(card, M):
    """Padded (M < 8), full, two-group (M = 16) and multi-pass M; K with a
    ragged tail (no multiple of the 16-row mma step, of 8, or even), K past
    one staged chunk of x, F that is no multiple of 512 or of 8; one split
    and many."""
    gen = torch.Generator(device=card).manual_seed(9)
    for K, F in ((200, 700), (1000, 512), (333, 1030), (4096, 1024), (2500, 33000), (14336, 520)):
        packed = quant.quantize_int8(torch.randn((K, F), generator=gen, device=card) * 0.05)
        x = torch.randn((M, K), generator=gen, device=card).to(torch.bfloat16)
        before = im.int8_matmul.launches
        y = im.int8_matmul(x, packed["q"], packed["scale"])
        assert im.int8_matmul.launches == before + 1
        assert tuple(y.shape) == (M, F) and y.dtype == torch.bfloat16
        ref = im.int8_matmul_plain(x, packed["q"], packed["scale"])
        # exact products, f32 sums in another order: within one bf16 step of
        # the largest output
        torch.testing.assert_close(
            y.float(), ref.float(), rtol=0, atol=2.0**-7 * float(ref.abs().max()), msg=f"{K=} {F=}")


def test_int8_matmul_is_deterministic(card):
    """Split-K partials are summed in a fixed order: two calls agree bit for bit."""
    gen = torch.Generator(device=card).manual_seed(10)
    packed = quant.quantize_int8(torch.randn((4096, 4096), generator=gen, device=card) * 0.05)
    x = torch.randn((8, 4096), generator=gen, device=card).to(torch.bfloat16)
    assert im.mma_plan(4096, 4096)[0] > 1
    assert torch.equal(im.int8_matmul(x, packed["q"], packed["scale"]),
                       im.int8_matmul(x, packed["q"], packed["scale"]))


def test_paged_attention_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(1)
    B, Hq, Hkv, Dh, page, pmax = 4, 8, 2, 128, 16, 8
    P = 1 + B * pmax
    k = torch.randn((P, page, Hkv, Dh), generator=gen, device=card).to(torch.bfloat16)
    v = torch.randn((P, page, Hkv, Dh), generator=gen, device=card).to(torch.bfloat16)
    tables = (1 + torch.randperm(B * pmax, generator=gen, device=card)).reshape(B, pmax).int()
    tables[0] = 0  # a dead row on the scratch page
    for T, positions in ((1, [0, 5, 70, page * pmax - 1]), (3, [0, 17, 40, page * pmax - 3])):
        q = torch.randn((B, T, Hq, Dh), generator=gen, device=card).to(torch.bfloat16)
        pos = torch.tensor(positions, dtype=torch.int32, device=card)
        out = pa.paged_attention(q, k, v, tables, pos)
        ref = pa.paged_attention_plain(q, k, v, tables, pos)
        assert bool(torch.isfinite(out.float()).all())
        # both f32 inside, one bf16 rounding of |out| < ~2 (2^-8 relative)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


def test_flash_attention_kernel_matches_plain(card):
    gen = torch.Generator(device=card).manual_seed(2)
    for B, T, Hq, Hkv, D in ((2, 512, 8, 2, 128), (1, 77, 4, 4, 128), (2, 130, 4, 1, 64)):
        q = torch.randn((B, T, Hq, D), generator=gen, device=card).to(torch.bfloat16)
        k = torch.randn((B, T, Hkv, D), generator=gen, device=card).to(torch.bfloat16)
        v = torch.randn((B, T, Hkv, D), generator=gen, device=card).to(torch.bfloat16)
        before = fa.flash_attention_causal.launches
        out = fa.flash_attention_causal(q, k, v)
        assert fa.flash_attention_causal.launches == before + 1
        # f32 sums and softmax, p rounded to bf16 before P.V (the plain
        # version keeps it f32): an output in [2, 4) may land one bf16 step
        # (2^-6) away; each row also within 5 % of its own RMS
        _assert_rows_close(out, fa.flash_attention_plain(q, k, v), atol=2e-2)


def _assert_rows_close(out, ref, atol):
    """Absolute agreement, and each output row (last axis) within 5 % of its
    own RMS: a row averaging many V rows has small outputs, which an
    absolute limit set by the short rows would not hold."""
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=atol)
    diff = (out.float() - ref.float()).abs().amax(dim=-1)
    rms = ref.float().pow(2).mean(dim=-1).sqrt().clamp_min(1e-6)
    assert float((diff / rms).max()) <= 0.05


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_paged_attention_split_edges_match_plain(card, kv_dtype, Dh):
    """Rows whose last query ends on a split's last token and on the next
    split's first, one spanning every split of its table, a mid-table row
    and a dead row, at T = 1 and 4, for G = 4 and G = 6 (row groups of the
    kernel cut mid-head)."""
    gen = torch.Generator(device=card).manual_seed(7)
    B, Hkv, page, pmax = 5, 2, 16, 80
    st, nsplit = pa.split_plan(pmax, page)
    S = pmax * page
    assert nsplit == 3 and st == pa.SPLIT_TOKENS
    P = 1 + B * pmax
    dense = [torch.randn((P, page, Hkv, Dh), generator=gen, device=card) for _ in range(2)]
    if kv_dtype == "bfloat16":
        (k, v), scales = (t.to(torch.bfloat16) for t in dense), ()
    else:
        codec = llama.quantize_kv if kv_dtype == "int8" else llama.quantize_kv_int4
        (k, ks), (v, vs) = codec(dense[0]), codec(dense[1])
        scales = (ks, vs)
    tables = (1 + torch.randperm(B * pmax, generator=gen, device=card)).reshape(B, pmax).int()
    tables[0] = 0  # a dead row on the scratch page
    last = [0, st - 1, st, S - 1, 700]  # the last query position of each row
    for Hq in (8, 12):
        for T in (1, 4):
            pos = torch.tensor([0] + [p - (T - 1) for p in last[1:]], dtype=torch.int32, device=card)
            q = torch.randn((B, T, Hq, Dh), generator=gen, device=card).to(torch.bfloat16)
            before = pa.paged_attention.launches[kv_dtype]
            out = pa.paged_attention(q, k, v, tables, pos, *scales)
            assert pa.paged_attention.launches[kv_dtype] == before + 1
            ref = pa.paged_attention_plain(q, k, v, tables, pos, *scales)
            # f32 inside both (scales folded after the integer dots), one
            # bf16 rounding of |out| < ~2
            _assert_rows_close(out, ref, atol=1e-2)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_flash_attention_tiles_match_plain(card, D, G):
    """T at and around the kernel's 64-row tiles and up to two full waves,
    for MHA, Llama-3's GQA and a wider group."""
    gen = torch.Generator(device=card).manual_seed(8)
    Hq = 8
    for T in (2, 63, 64, 65, 300, 512, 1024):
        q = torch.randn((2, T, Hq, D), generator=gen, device=card).to(torch.bfloat16)
        k = torch.randn((2, T, Hq // G, D), generator=gen, device=card).to(torch.bfloat16)
        v = torch.randn((2, T, Hq // G, D), generator=gen, device=card).to(torch.bfloat16)
        before = fa.flash_attention_causal.launches
        out = fa.flash_attention_causal(q, k, v)
        assert fa.flash_attention_causal.launches == before + 1
        # |out| < ~3; the kernel rounds p to bf16 before P.V (the plain
        # version keeps it f32), which can move an output in [2, 4) across
        # a rounding boundary: one bf16 step there is 2^-6
        _assert_rows_close(out, fa.flash_attention_plain(q, k, v), atol=2e-2)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_paged_attention_kernel_matches_plain(card, kv_dtype):
    gen = torch.Generator(device=card).manual_seed(3)
    codec = llama.quantize_kv if kv_dtype == "int8" else llama.quantize_kv_int4
    for Dh in (64, 128, 256):
        B, Hq, Hkv, page, pmax = 4, 8, 2, 16, 8
        P = 1 + B * pmax
        k, ks = codec(torch.randn((P, page, Hkv, Dh), generator=gen, device=card))
        v, vs = codec(torch.randn((P, page, Hkv, Dh), generator=gen, device=card))
        tables = (1 + torch.randperm(B * pmax, generator=gen, device=card)).reshape(B, pmax).int()
        tables[0] = 0  # a dead row on the scratch page
        for T, positions in ((1, [0, 5, 70, page * pmax - 1]), (4, [0, 17, 40, page * pmax - 4])):
            q = torch.randn((B, T, Hq, Dh), generator=gen, device=card).to(torch.bfloat16)
            pos = torch.tensor(positions, dtype=torch.int32, device=card)
            before = pa.paged_attention.launches[kv_dtype]
            out = pa.paged_attention(q, k, v, tables, pos, ks, vs)
            assert pa.paged_attention.launches[kv_dtype] == before + 1
            ref = pa.paged_attention_plain(q, k, v, tables, pos, ks, vs)
            assert bool(torch.isfinite(out.float()).all())
            # f32 inside both (scales folded after the integer dots), one
            # bf16 rounding of |out| < ~2
            torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("M", [1, 8, 16, 37, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w8a8_matmul_kernel_is_bitwise_its_plain_version(card, M, dtype):
    """One launch with the quantizer inside, bitwise the plain version
    (quantize_rows, exact int32 sums, the same f32 epilogue): one pass
    (M <= 8), two row groups (16), passes of 16 (37, 128); K with a ragged
    tail, past one staged split and at w_down's 14336; one split and many.
    Row 0 is all zero (its scale clamps to 1e-8) and the last row has
    absmax 127, so s = 1 and 2.5, -3.5 and 0.5 must round to even."""
    gen = torch.Generator(device=card).manual_seed(4)
    for K, F in ((200, 700), (4096, 1024), (1000, 512), (384, 1536), (14336, 520), (333, 33000)):
        packed = quant.quantize_int8(torch.randn((K, F), generator=gen, device=card) * 0.05)
        x = (torch.randn((M, K), generator=gen, device=card) * 3).to(dtype)
        x[0] = 0
        x[-1, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5], device=card) if M > 1 else 0
        before = im.int8_w8a8_matmul.launches
        y = im.int8_w8a8_matmul(x, packed["q"], packed["scale"])
        assert im.int8_w8a8_matmul.launches == before + 1
        assert tuple(y.shape) == (M, F) and y.dtype == torch.bfloat16
        assert torch.equal(y, im.int8_w8a8_matmul_plain(x, packed["q"], packed["scale"])), (M, K, F)


@pytest.mark.parametrize("two_launch_k", [0, 1 << 30], ids=["two-launches", "one-launch"])
def test_w8a8_matmul_launch_variants_are_bitwise_its_plain_version(card, monkeypatch, two_launch_k):
    """Both variants at every K: the quantizer inside the product's one
    launch, and as a launch of its own (what K >= W8A8_TWO_LAUNCH_K takes)."""
    monkeypatch.setattr(im, "W8A8_TWO_LAUNCH_K", two_launch_k)
    gen = torch.Generator(device=card).manual_seed(8)
    for M, K, F in ((1, 200, 700), (8, 4096, 1024), (16, 14336, 520), (37, 333, 1536)):
        packed = quant.quantize_int8(torch.randn((K, F), generator=gen, device=card) * 0.05)
        x = torch.randn((M, K), generator=gen, device=card).to(torch.bfloat16)
        y = im.int8_w8a8_matmul(x, packed["q"], packed["scale"])
        assert torch.equal(y, im.int8_w8a8_matmul_plain(x, packed["q"], packed["scale"])), (M, K, F)


def test_w8a8_matmul_is_deterministic_and_leaves_its_tickets_zero(card):
    gen = torch.Generator(device=card).manual_seed(6)
    packed = quant.quantize_int8(torch.randn((4096, 4096), generator=gen, device=card) * 0.05)
    x = torch.randn((8, 4096), generator=gen, device=card).to(torch.bfloat16)
    assert im.w8a8_plan(4096, 4096)[0] > 1  # split-K: partials, tickets, a summing block
    first = im.int8_w8a8_matmul(x, packed["q"], packed["scale"])
    assert torch.equal(first, im.int8_w8a8_matmul(x, packed["q"], packed["scale"]))
    tickets = _build.tickets("int8_w8a8_matmul", x, 4096 // im._MMA_TILE_F)
    torch.cuda.synchronize()
    assert int(tickets.abs().sum()) == 0


def test_w8a8_wrapper_launches_once_and_computes_nothing_in_torch(card):
    """Around its one ctypes launch the wrapper only allocates (y, the
    split-K partials) and makes views: no quantize, no padded copy."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=card).manual_seed(7)
    packed = quant.quantize_int8(torch.randn((4096, 4096), generator=gen, device=card) * 0.05)
    x = torch.randn((8, 4096), generator=gen, device=card).to(torch.bfloat16)
    im.int8_w8a8_matmul(x, packed["q"], packed["scale"])  # builds the library and the tickets
    torch.cuda.synchronize()
    before = im.int8_w8a8_matmul.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        im.int8_w8a8_matmul(x, packed["q"], packed["scale"])
    assert im.int8_w8a8_matmul.launches == before + 1
    ops = {e.name for e in prof.events() if e.name.startswith("aten::")}
    views = {"aten::empty", "aten::view", "aten::reshape", "aten::_reshape_alias",
             "aten::as_strided", "aten::_unsafe_view"}
    assert "aten::empty" in ops and ops <= views, ops


def test_w8a8_matmul_refuses_other_activation_dtypes(card):
    packed = quant.quantize_int8(torch.ones((64, 96), device=card))
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        im.int8_w8a8_matmul(torch.ones((2, 64), dtype=torch.float16, device=card),
                            packed["q"], packed["scale"])


def test_w8a8_prefill_path_is_bitwise_the_plain_formula(card):
    gen = torch.Generator(device=card).manual_seed(5)
    for M, K, F in ((300, 200, 700), (1024, 4096, 6144)):
        packed = quant.quantize_int8(torch.randn((K, F), generator=gen, device=card) * 0.05)
        x = torch.randn((M, K), generator=gen, device=card).to(torch.bfloat16)
        y = im.int8_matmul_w8a8_prefill(x, packed["q"], packed["scale"])
        assert torch.equal(y, im.int8_w8a8_matmul_plain(x, packed["q"], packed["scale"])), (M, K, F)


def test_wrappers_refuse_what_the_kernels_do_not_serve(card):
    q = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16, device=card)
    pool = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16, device=card)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, tables, torch.zeros(1, dtype=torch.int32, device=card))
    x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        fa.flash_attention_causal(x, x[:, :, :1], x[:, :, :1])
    # an int8 pool without its scales, a packed pool of the wrong width
    q = torch.zeros((1, 1, 4, 128), dtype=torch.bfloat16, device=card)
    pool8 = torch.zeros((2, 8, 2, 128), dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool8, pool8, tables, torch.zeros(1, dtype=torch.int32, device=card))
    pool4 = torch.zeros((2, 8, 2, 128), dtype=torch.uint8, device=card)
    scales = torch.ones((2, 8, 2), device=card)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool4, pool4, tables, torch.zeros(1, dtype=torch.int32, device=card),
                           scales, scales)


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_decode_attention_kernel_matches_plain(card, Dh):
    gen = torch.Generator(device=card).manual_seed(6)
    B, Hkv, S = 4, 2, 640
    for Hq in (8, 2, 12):  # G = 4 (llama3-8b), 1, and 6 (two head groups, one partial)
        k, ks = llama.quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=card))
        v, vs = llama.quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=card))
        ks, vs = ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()  # [B, Hkv, 1, S]
        q = torch.randn((B, Hq, Dh), generator=gen, device=card).to(torch.bfloat16)
        # a dead slot at 0, a partial tile, a position past capacity, a full strip
        pos = torch.tensor([0, 37, S + 5, S - 1], dtype=torch.int32, device=card)
        before = da.decode_attention.launches
        out = da.decode_attention(q, k, ks, v, vs, pos)
        assert da.decode_attention.launches == before + 1
        ref = da.decode_attention_plain(q, k, ks, v, vs, pos)
        assert bool(torch.isfinite(out.float()).all())
        # f32 inside both (scales folded after the integer dots), one bf16
        # rounding of |out| < ~2
        torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=1e-2)


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 6])
def test_decode_attention_split_edges_match_plain(card, Dh, G):
    """Slots ending on a split's last row and on the next split's first, on
    a tile edge inside a later split, at the strip's last row, past it, a
    slot with one live row and one with none, over three splits; twice, so
    the second launch finds the merge tickets the first one left."""
    gen = torch.Generator(device=card).manual_seed(11)
    Hkv = 2
    st = da.SPLIT_ROWS
    S = 2 * st + 100
    assert da.split_plan(S) == (st, 3)
    last = [st - 1, st, 2 * st - 1, 2 * st, st + 64, S - 1, S + 7, 0, -1]
    B = len(last)
    k, ks = llama.quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=card))
    v, vs = llama.quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=card))
    ks, vs = ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()
    pos = torch.tensor(last, dtype=torch.int32, device=card)
    for _ in range(2):
        q = torch.randn((B, Hkv * G, Dh), generator=gen, device=card).to(torch.bfloat16)
        before = da.decode_attention.launches
        out = da.decode_attention(q, k, ks, v, vs, pos)
        assert da.decode_attention.launches == before + 1
        ref = da.decode_attention_plain(q, k, ks, v, vs, pos)
        # f32 inside both (scales folded after the integer dots), one bf16
        # rounding of |out| < ~2; each (slot, head) within 5 % of its RMS
        _assert_rows_close(out, ref, atol=1e-2)
        assert float(out[-1].float().abs().max()) == 0.0  # no live row: 0, not NaN


def test_decode_attention_one_split_needs_no_workspace(card):
    """A strip one split covers: written directly (the wrapper passes no
    workspace), at capacity and past it."""
    gen = torch.Generator(device=card).manual_seed(12)
    B, Hq, Hkv, S, Dh = 3, 8, 2, da.SPLIT_ROWS, 128
    assert da.workspace_elements(B, Hq, Dh, da.split_plan(S)[1]) == 0
    k, ks = llama.quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=card))
    v, vs = llama.quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=card))
    ks, vs = ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()
    q = torch.randn((B, Hq, Dh), generator=gen, device=card).to(torch.bfloat16)
    pos = torch.tensor([S - 1, 63, S + 3], dtype=torch.int32, device=card)
    out = da.decode_attention(q, k, ks, v, vs, pos)
    _assert_rows_close(out, da.decode_attention_plain(q, k, ks, v, vs, pos), atol=1e-2)


def test_decode_attention_wrapper_refuses_what_the_kernel_does_not_serve(card):
    B, Hkv, S = 1, 2, 64
    q = torch.zeros((B, 4, 128), dtype=torch.bfloat16, device=card)
    k = torch.zeros((B, Hkv, S, 128), dtype=torch.int8, device=card)
    s = torch.ones((B, Hkv, 1, S), device=card)
    pos = torch.zeros(B, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):  # a bf16 cache
        da.decode_attention(q, k.to(torch.bfloat16), s, k.to(torch.bfloat16), s, pos)
    with pytest.raises(ValueError):  # scales without the unit axis
        da.decode_attention(q, k, s[:, :, 0], k, s[:, :, 0], pos)
    with pytest.raises(ValueError):  # int64 positions (the caller casts once per step)
        da.decode_attention(q, k, s, k, s, pos.long())
    with pytest.raises(ValueError):  # a head dim the kernel is not built for
        q16 = torch.zeros((B, 4, 16), dtype=torch.bfloat16, device=card)
        k16 = torch.zeros((B, Hkv, S, 16), dtype=torch.int8, device=card)
        da.decode_attention(q16, k16, s, k16, s, pos)


# --------------------------------------------------------------------------- #
# the retrieval side on the card (no kernel of its own: plain PyTorch)


def _bert_inputs(gen, device, lengths, T, vocab=256):
    ids = torch.randint(0, vocab, (len(lengths), T), generator=gen, device=device, dtype=torch.int32)
    mask = torch.zeros((len(lengths), T), dtype=torch.int32, device=device)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1
    return ids, mask


def test_bert_encoder_on_the_card_matches_the_cpu(card):
    """arctic-embed-l's width at 2 layers: the card's f32 path equals the
    CPU's within 1e-5 (no TF32 anywhere), its bf16 path within cosine
    0.999 and max |d| 1e-2 (the bounds chip_smoke.py holds at full depth)."""
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.models.convert import _map

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = bert.BertConfig(num_layers=2)
    params = bert.init_bert_params(cfg, torch.Generator(device=card).manual_seed(0))
    ids, mask = _bert_inputs(torch.Generator(device=card).manual_seed(1), card, (200, 64, 17), 200)
    cpu32 = _map(params, lambda t: t.to("cpu", torch.float32))
    with torch.inference_mode():
        ref = bert.bert_encode(cpu32, cfg, ids.cpu(), mask.cpu())
        f32 = bert.bert_encode(_map(params, lambda t: t.float()), cfg, ids, mask).cpu()
        bf16 = bert.bert_encode(params, cfg, ids, mask).cpu()
    assert float((f32 - ref).abs().max()) <= 1e-5
    assert float((bf16 - ref).abs().max()) <= 1e-2
    assert float(torch.nn.functional.cosine_similarity(bf16, ref).min()) >= 0.999


def test_embedder_paths_agree_on_the_card(card):
    """The batched path (with concurrent queries) against the synchronous
    one, on the card. The documents go in the same batches both ways:
    bitwise. The 4 concurrent queries coalesce into one dispatch of 4 rows
    where the synchronous query went alone; cuBLAS may tile that shape
    differently, so those are held within cosine 0.999 and max |d| 1e-2
    (chip_smoke.py's bounds)."""
    import threading

    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder

    emb = TorchEmbedder(model_name="arctic-embed-m", device=card, query_cache_size=0,
                        batching=types.SimpleNamespace(enable="on", max_wait_ms=5.0,
                                                       max_batch_embed=8, max_batch_rerank=8,
                                                       ingest_decode_yield_ms=0.0))
    try:
        texts = [f"document {i} about mesh sharding and kv caches " * (1 + i % 5) for i in range(13)]
        emb.set_batching(False)
        sync_docs, sync_q = emb.embed_documents(texts), emb.embed_query("how are caches shared")
        emb.set_batching(True)
        outs = {}

        def worker(kind, i):
            outs[(kind, i)] = (emb.embed_documents(texts) if kind == "docs"
                               else emb.embed_query("how are caches shared"))

        threads = [threading.Thread(target=worker, args=("docs", 0), daemon=True)] + [
            threading.Thread(target=worker, args=("q", i), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        assert np.array_equal(outs[("docs", 0)], sync_docs)
        for i in range(4):
            got = outs[("q", i)]
            cos = float(got @ sync_q / np.linalg.norm(got) / np.linalg.norm(sync_q))
            assert cos >= 0.999 and np.abs(got - sync_q).max() <= 1e-2
    finally:
        emb.close()


def test_embedder_readback_does_not_wait_for_the_default_stream(card):
    """The encoder runs on a stream of its own: with ~1 s of work queued on
    the default stream (where the LLM engine decodes), an embed returns
    long before that work ends; so does a search. Both are warmed on the
    same shapes first: the first launch of a kernel that CUDA has not
    loaded yet (lazy module loading) waits for the whole card."""
    import time

    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.retrieval.ann import ANNSearchEngine

    emb = TorchEmbedder(model_name="debug", device=card,
                        batching=types.SimpleNamespace(enable="off"))
    ann = ANNSearchEngine(64, device=card)
    corpus = np.random.default_rng(0).standard_normal((100, 64)).astype(np.float32)
    ann.refresh(corpus, version=1)
    text = "a passage while the default stream is busy"
    emb.embed_documents([text])
    ann.search(corpus[:2], 4)
    torch.cuda.synchronize()
    done = torch.cuda.Event()
    torch.cuda._sleep(2_000_000_000)  # ~1 s at the card's clock, on the default stream
    done.record()
    t0 = time.perf_counter()
    vec = emb.embed_documents([text])
    _, idx = ann.search(corpus[:2], 4)
    elapsed = time.perf_counter() - t0
    busy = not done.query()
    torch.cuda.synchronize()
    emb.close()
    assert vec.shape == (1, 64) and list(idx[:, 0]) == [0, 1]
    assert busy, "the spin ended first: the check proves nothing"
    assert elapsed < 0.5


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_ann_search_on_the_card_matches_numpy(card, mode):
    """Exact search, and IVF with every list probed, against numpy's brute
    force: scores within 1e-5, indices equal where the neighbouring score
    is more than 1e-5 away."""
    from generativeaiexamples_tpu_torch.retrieval.ann import ANNSearchEngine

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((20000, 256)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = corpus[rng.choice(20000, 8)] + 0.05 * rng.standard_normal((8, 256)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    eng = ANNSearchEngine(256, mode=mode, nlist=16, nprobe=16, device=card)
    eng.refresh(corpus, version=1)
    got_s, got_i = eng.search(queries, 16)
    scores = queries @ corpus.T
    want_i = np.argsort(-scores, axis=1, kind="stable")[:, :16]
    want_s = np.take_along_axis(scores, want_i, axis=1)
    assert np.abs(got_s - want_s).max() <= 1e-5
    for r in range(8):
        for j in range(16):
            gap = min(abs(want_s[r, j] - want_s[r, j - 1]) if j else np.inf,
                      abs(want_s[r, j] - want_s[r, j + 1]) if j < 15 else np.inf)
            if gap > 1e-5:
                assert got_i[r, j] == want_i[r, j], (r, j)
