"""Sweep the launch plans of the port's split kernels on one GPU.

    python3 kernel_sweep.py

Times, with ``chip_smoke.py``'s ``Timer`` (L2 flushed, a spin kernel ahead
of every call) and at the llama3-8b shapes of ``chip_smoke.py``'s phase 3:

- ``decode_attention`` at several values of ``SPLIT_ROWS`` on the four
  decode cases (ragged, uniform, short, split_edge);
- ``int8_matmul`` at M = 8 at several split-K counts for each projection
  and the lm_head, beside the count ``mma_plan`` picks;
- ``int8_w8a8_matmul`` at M = 1 and 8 for each projection and the lm_head,
  its quantizer inside the one launch against the two-launch variant (the
  quantizer as a launch of its own), each held bitwise against the plain
  version.

``--sweeps decode,int8,w8a8`` picks which run (default: all).

Every timed configuration is first held against the plain version. The
constants it sweeps (``ops/decode_attention.py`` ``SPLIT_ROWS``,
``ops/int8_matmul.py`` ``mma_plan`` and ``W8A8_TWO_LAUNCH_K``) were chosen
from its output; PERF.md
quotes it. It prints the card's name and power limit first, needs a CUDA
device and imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys

import torch

from chip_smoke import MODEL, Timer, phase_device
from generativeaiexamples_tpu_torch.models.llama import PRESETS, quantize_kv
from generativeaiexamples_tpu_torch.ops import decode_attention as da
from generativeaiexamples_tpu_torch.ops import int8_matmul as im


def sweep_decode(timer, dev, gen) -> None:
    cfg = PRESETS[MODEL]
    B, S, Hq, Hkv, Dh = 8, 8192, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_q, k_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    v_q, v_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    k_s, v_s = k_s[:, :, None, :].contiguous(), v_s[:, :, None, :].contiguous()
    q = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
    cases = {
        "ragged": [8191, 100, 112, 125, 131, 144, 160, 0],
        "uniform": [2047] * B,
        "short": [100, 131, 157, 0, 176, 199, 220, 143],
        "split_edge": [511, 512, 1023, 1024, 4095, 4096, 8191, 0],
    }
    kept = da.SPLIT_ROWS
    try:
        for rows in (256, 512, 1024, kept):
            da.SPLIT_ROWS = rows
            for case, positions in cases.items():
                pos = torch.tensor(positions, dtype=torch.int32, device=dev)
                args = (q, k_q, k_s, v_q, v_s, pos)
                err = float((da.decode_attention(*args).float()
                             - da.decode_attention_plain(*args).float()).abs().max())
                if err > 1e-2:
                    raise AssertionError(f"decode_attention SPLIT_ROWS={rows} {case}: max|err| {err}")
                ms = timer.ms(lambda: da.decode_attention(*args))
                print(f"decode_attention SPLIT_ROWS={rows}{' (kept)' if rows == kept else ''} "
                      f"{case}: {ms:.4f} ms max|err|={err:.3g}", flush=True)
    finally:
        da.SPLIT_ROWS = kept


def sweep_int8(timer, dev, gen) -> None:
    cfg = PRESETS[MODEL]
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "wqkv": (h, cfg.q_dim + 2 * cfg.kv_dim), "wo": (cfg.q_dim, h), "w_gateup": (h, 2 * f),
        "w_down": (f, h), "lm_head": (h, cfg.vocab_size),
    }
    plan = im.mma_plan
    try:
        for name, (K, F) in shapes.items():
            F_pad = -(-F // im.F_BLK) * im.F_BLK
            q = torch.zeros((K, F_pad), dtype=torch.int8, device=dev)
            q[:, :F].random_(-127, 128, generator=gen)
            scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
            x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
            ref = im.int8_matmul_plain(x, q, scale)
            picked = plan(K, F_pad)
            rounds = -(-K // im._MMA_K_ROUND)
            tried = {picked}
            for want in (1, 2, 3, 4, 5, 6, 8, 9, 11, 16):
                k_chunk = -(-rounds // want) * im._MMA_K_ROUND
                tried.add((-(-K // k_chunk), k_chunk))
            for splits, k_chunk in sorted(tried):
                im.mma_plan = lambda K_, F_, p=(splits, k_chunk): p
                err = float((im.int8_matmul(x, q, scale).float() - ref.float()).abs().max())
                if err > 1e-2 * float(ref.float().abs().max()):
                    raise AssertionError(f"int8_matmul {name} splits={splits}: max|err| {err}")
                ms = timer.ms(lambda: im.int8_matmul(x, q, scale))
                print(f"int8_matmul {name} M=8 splits={splits} k_chunk={k_chunk} "
                      f"blocks={splits * F_pad // im._MMA_TILE_F}"
                      f"{' (mma_plan)' if (splits, k_chunk) == picked else ''}: {ms:.4f} ms",
                      flush=True)
            del q
    finally:
        im.mma_plan = plan


def sweep_w8a8(timer, dev, gen) -> None:
    cfg = PRESETS[MODEL]
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "wqkv": (h, cfg.q_dim + 2 * cfg.kv_dim), "wo": (cfg.q_dim, h), "w_gateup": (h, 2 * f),
        "w_down": (f, h), "lm_head": (h, cfg.vocab_size),
    }
    kept = im.W8A8_TWO_LAUNCH_K
    try:
        for name, (K, F) in shapes.items():
            F_pad = -(-F // im.F_BLK) * im.F_BLK
            q = torch.zeros((K, F_pad), dtype=torch.int8, device=dev)
            q[:, :F].random_(-127, 128, generator=gen)
            scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
            for M in (1, 8):
                x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
                ref = im.int8_w8a8_matmul_plain(x, q, scale)
                for label, two_from in (("one launch", 1 << 30), ("two launches", 0)):
                    im.W8A8_TWO_LAUNCH_K = two_from
                    if not torch.equal(im.int8_w8a8_matmul(x, q, scale), ref):
                        raise AssertionError(f"int8_w8a8_matmul {name} M={M} {label}: not bitwise")
                    ms = timer.ms(lambda: im.int8_w8a8_matmul(x, q, scale))
                    print(f"int8_w8a8_matmul {name} M={M} K={K} {label}"
                          f"{' (kept)' if (K >= kept) == (two_from == 0) else ''}: {ms:.4f} ms",
                          flush=True)
            del q
    finally:
        im.W8A8_TWO_LAUNCH_K = kept


SWEEPS = {"decode": sweep_decode, "int8": sweep_int8, "w8a8": sweep_w8a8}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sweeps", default=",".join(SWEEPS),
                        help="which sweeps, comma-separated (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    phase_device()
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in args.sweeps.split(","):
        SWEEPS[name](timer, dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
