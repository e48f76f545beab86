"""The CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere. The file
imports nothing of JAX, so it runs on the GPU machine on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels_on_card.py

(``--noconftest``: the repository's conftest sets up JAX's CPU platform.)
chip_smoke.py checks the same kernels at the llama3-8b shapes."""
import pytest
import torch

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
        out = fa.flash_attention_causal(q, k, v)
        # both f32 inside, one bf16 rounding of |out| < ~3 (2^-8 relative)
        torch.testing.assert_close(out.float(), fa.flash_attention_plain(q, k, v).float(), rtol=0, atol=1e-2)


def test_wrappers_refuse_what_the_kernels_do_not_serve(card):
    q = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16, device=card)
    pool = torch.zeros((2, 8, 2, 16), dtype=torch.bfloat16, device=card)
    tables = torch.zeros((1, 1), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, tables, torch.zeros(1, dtype=torch.int32, device=card))
    x = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        fa.flash_attention_causal(x, x[:, :, :1], x[:, :, :1])
