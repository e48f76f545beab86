"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each one's failure makes the script exit non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the serving path from ``csrc/`` (five
   files, one nvcc each, all started together);
3. each kernel against its plain PyTorch version at the serving path's
   shapes for llama3-8b, with its time, the plain version's, one library
   call's as a yardstick, and its bound: int8_matmul and int8_w8a8_matmul
   at the four projections and the lm_head (M = 1 and 8; int8_matmul also
   at M = 4 and 16, untimed; int8_w8a8_matmul also at M = 16 and 128 and
   with f32 x, timed), paged_attention over bf16, int8 and int4
   pools (ragged, uniform, short and split-edge rows),
   flash_attention_causal at (2, 512) and (2, 300), decode_attention over
   the fixed layout's int8 cache (ragged, uniform, short and split-edge
   slots);
4. model level at full llama3-8b width and depth (int8 packs, random from
   a seed), for each paged serving recipe (int8 weights + bf16 KV, w8a8 +
   int8 KV, int8 weights + int4 KV) and for the fixed layout (int8 weights
   + int8 cache): one 512-token prefill and 8 decode steps on the kernel
   path and on the plain path, logits and greedy tokens compared; the
   fixed kernel path against the paged int8 kernel path;
5. serve: four engines at full llama3-8b width and depth, built one
   after another: A (int8 weights, bf16 KV), B (w8a8, int8 KV) and D
   (int8 weights, int8 KV, fixed layout) behind the OpenAI-compatible
   HTTP server with a few concurrent requests (chat streaming and not,
   completions, one prompt longer than ``prefill_chunk``), then 8
   concurrent ``generate_ids`` on each of A, B, C (int8 weights, int4 KV)
   and D. Every kernel's launch count is set to 0 just before each engine
   serves and read just after. Each engine also reports its device time
   and its kernel launches per decode step, and the synchronizing CUDA
   calls each thread made while it served (``torch.cuda.set_sync_debug_mode``):
   the dispatch thread must make none; the reader waits once per readback.
   Engine A is then held against a second engine on the same weights at
   ``decode_runahead`` 1 (the same streams, greedy and a seeded sampled
   row), and that engine, built with ``max_queued_requests`` =
   ``max_batch_size``, takes more concurrent HTTP requests than fit: some
   answer 429 with ``Retry-After`` and ``X-GenAI-Queue-Depth``, the rest
   200. First, a thread's wait on a CUDA event must release the GIL.

6. retrieval: arctic-embed-l (the embedder) and arctic-embed-m (the
   reranker) at full width on the card, random from ``--seed``: 4
   passages on the card (bf16) against the CPU's f32 plain path; 512
   passages of 32-512 ids through the batched path, then the synchronous
   one, held to each other (and 8 rows alone against their batch), with
   passages/s, tokens/s and the device time of a dispatch at (32, 512),
   (32, 128) and (1, 64) with its share of the bf16 peak; a 65,536 x
   1024 store searched exact and IVF (nlist 64, nprobe 16) for 8
   embed_query vectors, exact held against numpy, search times at rows 1
   and 8 and k 4 and 16, IVF recall; each query's top 16 reranked, the
   logits held against the CPU's; then engine A behind the HTTP server
   with this embedder: ``/v1/embeddings`` and ``/v1/models``, and while 8
   greedy requests decode, an ingest of 64 passages that must wait on the
   engine's ``ingest_window``, ungated embed_query calls, and no
   synchronizing call on the LLM dispatch thread.

With no arguments it runs every phase, as above; ``--phases``,
``--checks`` and ``--recipes`` run a part (for example ``--phases serve
--recipes B``) and then print only the kernels that part measured;
``--runahead N`` serves every engine at ``decode_runahead`` N, and
``--timing-only`` leaves out the runahead and overload checks (for timed
runs of an older tree, which lacks them).

It then prints one JSON line of per-kernel results and, last, the device
line. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import torch

from generativeaiexamples_tpu_torch.config import EngineConfig as _EngineConfig
from generativeaiexamples_tpu_torch.ops import _build
from generativeaiexamples_tpu_torch.ops import decode_attention as da
from generativeaiexamples_tpu_torch.ops import flash_attention as fa
from generativeaiexamples_tpu_torch.ops import int8_matmul as im
from generativeaiexamples_tpu_torch.ops import page_attention as pa
from generativeaiexamples_tpu_torch.utils import hardware

MODEL = "llama3-8b"
_PAGED = "generativeaiexamples_tpu/ops/page_attention.py:88"
# kernel entry -> (the TPU kernel it replaces, its source in the repo)
KERNELS = {
    "int8_matmul": ("generativeaiexamples_tpu/ops/int8_matmul.py:73",
                    "generativeaiexamples_tpu_torch/csrc/int8_matmul.cu"),
    "paged_attention[bfloat16]": (_PAGED, "generativeaiexamples_tpu_torch/csrc/page_attention.cu"),
    "paged_attention[int8]": (_PAGED, "generativeaiexamples_tpu_torch/csrc/page_attention.cu"),
    "paged_attention[int4]": (_PAGED, "generativeaiexamples_tpu_torch/csrc/page_attention.cu"),
    "flash_attention_causal": ("generativeaiexamples_tpu/ops/flash_attention.py:36",
                               "generativeaiexamples_tpu_torch/csrc/flash_attention.cu"),
    "int8_w8a8_matmul": ("generativeaiexamples_tpu/ops/int8_matmul.py:179",
                         "generativeaiexamples_tpu_torch/csrc/int8_w8a8_matmul.cu"),
    "decode_attention": ("generativeaiexamples_tpu/ops/decode_attention.py:75",
                         "generativeaiexamples_tpu_torch/csrc/decode_attention.cu"),
}
# whether the engine has the reader thread (an older tree's engine, timed
# against this one, decodes synchronously)
_HAS_READER = "decode_runahead" in _EngineConfig.__dataclass_fields__
_COUNTED = (im.int8_matmul, im.int8_w8a8_matmul, fa.flash_attention_causal, da.decode_attention)
# the serving recipes: (name, quantization, kv_cache_dtype, kv_layout, kernels its path must launch)
RECIPES = (
    ("A", "int8", "bfloat16", "paged",
     ("int8_matmul", "paged_attention[bfloat16]", "flash_attention_causal")),
    ("B", "w8a8", "int8", "paged",
     ("int8_w8a8_matmul", "paged_attention[int8]", "flash_attention_causal")),
    ("C", "int8", "int4", "paged",
     ("int8_matmul", "paged_attention[int4]", "flash_attention_causal")),
    ("D", "int8", "int8", "fixed",
     ("int8_matmul", "decode_attention", "flash_attention_causal")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for fn in _COUNTED:
        fn.launches = 0
    for kv in pa.paged_attention.launches:
        pa.paged_attention.launches[kv] = 0


def counts() -> dict:
    out = {fn.__name__: fn.launches for fn in _COUNTED}
    for kv, n in pa.paged_attention.launches.items():
        out[f"paged_attention[{kv}]"] = n
    return out


class Timer:
    """Median device time of one call: CUDA events around each call, the
    50 MB L2 flushed before it (the serving path finds weights and pages
    cold), and a ~1 ms spin kernel queued ahead of both so the host has
    enqueued the whole call before the device reaches it (the events then
    time the device, not Python's launch overhead)."""

    def __init__(self, device):
        self.flush = torch.zeros(64 * 1024 * 1024, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(2_000_000)
            # evict by reading: a write would leave ~50 MB of dirty lines
            # whose write-back then competes with the timed call
            self.flush.max()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# --------------------------------------------------------------------- #
# Phase 1-2


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return {"smi": smi}


def phase_build() -> None:
    t0 = time.time()
    reports = _build.build(verbose=True)
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")
    log(f"phase build: ok ({time.time() - t0:.1f} s)")


# --------------------------------------------------------------------- #
# Phase 3: kernels against their plain versions


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_int8(timer, dev, gen, results) -> None:
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "wqkv": (h, cfg.q_dim + 2 * cfg.kv_dim),
        "wo": (cfg.q_dim, h),
        "w_gateup": (h, 2 * f),
        "w_down": (f, h),
        "lm_head": (h, cfg.vocab_size),
    }
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0, "flops": 0, "err": 0.0}
    per_shape = {}
    for M in (1, 8):
        for name, (K, F) in shapes.items():
            K_pad = -(-K // im.K_ALIGN) * im.K_ALIGN
            F_pad = -(-F // im.F_BLK) * im.F_BLK
            q = torch.zeros((K_pad, F_pad), dtype=torch.int8, device=dev)
            q[:K, :F].random_(-127, 128, generator=gen)
            scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
            x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
            y = im.int8_matmul(x, q, scale)
            ref = im.int8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            err = _max_err(y, ref)
            tol = 1e-2 * float(ref.float().abs().max())  # ~2 bf16 ulps of the largest output
            w = (q[:K, :F].float() * scale).to(torch.bfloat16)
            k_ms = timer.ms(lambda: im.int8_matmul(x, q, scale))
            p_ms = timer.ms(lambda: im.int8_matmul_plain(x, q, scale), iters=5)
            l_ms = timer.ms(lambda: torch.matmul(x, w))
            nbytes, flops = hardware.int8_matmul_cost(M, K, F)
            b_ms, b_by = hardware.bound_ms(nbytes, flops)
            ok = err <= tol
            log(f"  int8_matmul {name:8s} M={M} K={K} F={F}: max|err|={err:.4g} tol={tol:.4g} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8_matmul {name} M={M} disagrees with its plain version")
            agg["err"] = max(agg["err"], err)
            per_shape[f"{name}_M{M}"] = {"ms": k_ms, "library_ms": l_ms, "bound_ms": b_ms}
            if M == 8 and name != "lm_head":  # one decoder layer's projections at B=8
                agg["ms"] += k_ms
                agg["plain_ms"] += p_ms
                agg["library_ms"] += l_ms
                agg["bytes"] += nbytes
                agg["flops"] += flops
            # a padded and a two-group M on the widest-K and a narrow-F shape,
            # correctness only
            if M == 8 and name in ("wqkv", "w_down"):
                for M2 in (4, 16):
                    x2 = torch.randn((M2, K), generator=gen, device=dev).to(torch.bfloat16)
                    y2 = im.int8_matmul(x2, q, scale)
                    ref2 = im.int8_matmul_plain(x2, q, scale)
                    torch.cuda.synchronize()
                    err2, tol2 = _max_err(y2, ref2), 1e-2 * float(ref2.float().abs().max())
                    log(f"  int8_matmul {name:8s} M={M2} K={K} F={F}: max|err|={err2:.4g} "
                        f"tol={tol2:.4g} (not timed) {'ok' if err2 <= tol2 else 'FAIL'}")
                    if err2 > tol2:
                        raise AssertionError(
                            f"int8_matmul {name} M={M2} disagrees with its plain version")
                    agg["err"] = max(agg["err"], err2)
            del q, w
    b_ms, b_by = hardware.bound_ms(agg["bytes"], agg["flops"])
    results["int8_matmul"] = {
        "max_abs_err": agg["err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": agg["library_ms"],
        "shape": "one layer's wqkv+wo+w_gateup+w_down at M=8",
        "per_shape": per_shape,
    }


def _paged_case(gen, dev, positions, Pmax, page, Hkv, Dh):
    """Page tables over a shuffled bf16 pool for rows at ``positions``: a
    row at position 0 is dead (its table points at the scratch page 0),
    every other row owns the pages up to its position."""
    B = len(positions)
    live = [p // page + 1 if p else 0 for p in positions]
    P = 1 + sum(live)
    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((B, Pmax), dtype=torch.int32)
    at = 0
    for b, n in enumerate(live):
        tables[b, :n] = torch.tensor(perm[at:at + n], dtype=torch.int32)
        at += n
    k = torch.randn((P, page, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((P, page, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return k, v, tables.to(dev), pos


def _per_row_rel_err(out, ref) -> float:
    """Max over rows of a call of max|err| / RMS of that row's reference
    outputs: a long row averages thousands of V rows, so its outputs are
    small and an absolute limit set by the short rows would let a fault on
    it pass. One bf16 rounding is 2^-9 of a value."""
    dims = tuple(range(1, out.dim()))
    diff = (out.float() - ref.float()).abs().amax(dim=dims)
    rms = ref.float().pow(2).mean(dim=dims).sqrt().clamp_min(1e-6)
    return float((diff / rms).max())


def check_paged(timer, dev, gen, results) -> None:
    """paged_attention at llama3-8b geometry (B=8, page 128, Pmax 64) for
    each pool (bf16 rows, and the same rows quantized to int8 and int4 with
    their scales) on four sets of rows: ragged (a dead row, a one-page row,
    a full 8191-token row, five at 200-1200), uniform (all at 2047), short
    (the smoke's serving traffic, 100-220 tokens, and a dead row), and
    split edges (rows ending on and just past split boundaries)."""
    from generativeaiexamples_tpu_torch.models.llama import (
        PRESETS, quantize_kv, quantize_kv_int4, unpack_int4,
    )

    cfg = PRESETS[MODEL]
    B, page, Pmax = 8, 128, 8192 // 128
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = Pmax * page
    st = pa.split_plan(Pmax, page)[0]
    ragged = [0, 50, S - 1] + [
        int(x) for x in torch.randint(200, 1200, (B - 3,), generator=gen, device=dev)
    ]
    cases = {
        "ragged": ragged,
        "uniform": [2047] * B,
        "short": [100, 131, 157, 0, 176, 199, 220, 143],
        "edges": [st - 1, st, 2 * st - 1, 2 * st, 0, 1, st + 1, S - 1],
    }
    rows = {kv: {} for kv in pa.KV_DTYPES}
    for case, positions in cases.items():
        k, v, tables, pos = _paged_case(gen, dev, positions, Pmax, page, Hkv, Dh)
        q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
        mask = (torch.arange(S, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
        qt = q.transpose(1, 2)
        for kv_dtype in pa.KV_DTYPES:
            codec = {"int8": quantize_kv, "int4": quantize_kv_int4}.get(kv_dtype)
            if codec is None:
                pool, scales, dense = (k, v), (None, None), (k, v)
            else:
                (kq, ks), (vq, vs) = codec(k), codec(v)
                pool, scales = (kq, vq), (ks, vs)
                ints = [unpack_int4(t) if t.dtype == torch.uint8 else t for t in pool]
                dense = tuple((i.float() * sc[..., None]).to(torch.bfloat16)
                              for i, sc in zip(ints, scales))
            args = (q, *pool, tables, pos, *scales)
            out = pa.paged_attention(*args)
            ref = pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            # outputs are convex mixes of N(0, 1) rows, f32 inside both, one
            # bf16 rounding of |out| < 1 (< 4e-3); and each row against 5 %
            # of its own RMS
            tol, rel_tol = 1e-2, 0.05
            rel = _per_row_rel_err(out, ref)
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"paged_attention[{kv_dtype}] {case}: non-finite values (dead row?)")
            k_ms = timer.ms(lambda: pa.paged_attention(*args))
            p_ms = timer.ms(lambda: pa.paged_attention_plain(*args), iters=5)
            # yardstick: SDPA over the rows' pre-gathered (dequantized) bf16
            # windows with a length mask
            gk, gv = (t[tables.long()].reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous()
                      for t in dense)
            l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, gk, gv, attn_mask=mask, enable_gqa=True))
            del gk, gv
            nbytes, flops = hardware.paged_attention_cost(
                [[p] for p in positions], Hq, Hkv, Dh, Pmax,
                kv_bytes=hardware.kv_bytes_per_element(kv_dtype),
                scale_bytes=0 if codec is None else 4,
            )
            b_ms, b_by = hardware.bound_ms(nbytes, flops)
            ok = err <= tol and rel <= rel_tol
            log(f"  paged_attention[{kv_dtype}] {case} B={B} positions={positions}: "
                f"max|err|={err:.4g} tol={tol} max per-row |err|/rms={rel:.4g} tol={rel_tol} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"paged_attention[{kv_dtype}] {case} disagrees with its plain version")
            rows[kv_dtype][case] = {
                "max_abs_err": err, "max_rel_err": rel, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            }
        del k, v
    for kv_dtype, by_case in rows.items():
        results[f"paged_attention[{kv_dtype}]"] = {
            **by_case["ragged"],
            "max_abs_err": max(r["max_abs_err"] for r in by_case.values()),
            "max_rel_err": max(r["max_rel_err"] for r in by_case.values()),
            "shape": f"B=8 decode rows over ragged tables, Hq=32 Hkv=8 Dh=128 page=128, "
                     f"{kv_dtype} pool",
            **{case: {**r, "positions": cases[case]} for case, r in by_case.items() if case != "ragged"},
        }


def check_w8a8(timer, dev, gen, results) -> None:
    """int8_w8a8_matmul (one launch, its quantizer inside) at the four fused
    projections and the lm_head, bitwise against its plain version (exact
    int32 sums and the same f32 quantizer on both sides) with bf16 x at
    M = 1, 8, 16 and 128 and f32 x at M = 8, every case timed; at M = 1 and
    8 also the plain version, the ``torch._int_mm`` yardstick and
    ``int8_matmul`` on the same pack, which streams the same bytes."""
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    h, f = cfg.hidden_size, cfg.intermediate_size
    shapes = {
        "wqkv": (h, cfg.q_dim + 2 * cfg.kv_dim),
        "wo": (cfg.q_dim, h),
        "w_gateup": (h, 2 * f),
        "w_down": (f, h),
        "lm_head": (h, cfg.vocab_size),
    }
    cases = ((1, torch.bfloat16), (8, torch.bfloat16), (16, torch.bfloat16),
             (128, torch.bfloat16), (8, torch.float32))
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "int8_matmul_ms": 0.0, "bytes": 0,
           "flops": 0, "err": 0.0}
    per_shape = {}
    for name, (K, F) in shapes.items():
        K_pad = -(-K // im.K_ALIGN) * im.K_ALIGN
        F_pad = -(-F // im.F_BLK) * im.F_BLK
        q = torch.zeros((K_pad, F_pad), dtype=torch.int8, device=dev)
        q[:K, :F].random_(-127, 128, generator=gen)
        scale = torch.rand((1, F), generator=gen, device=dev) * 2e-4 + 1e-4
        for M, dtype in cases:
            x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
            y = im.int8_w8a8_matmul(x, q, scale)
            ref = im.int8_w8a8_matmul_plain(x, q, scale)
            torch.cuda.synchronize()
            err = _max_err(y, ref)
            ok = torch.equal(y, ref)  # exact int32 sums and one epilogue on both sides
            k_ms = timer.ms(lambda: im.int8_w8a8_matmul(x, q, scale))
            nbytes, ops = hardware.w8a8_matmul_cost(M, K, F, x_bytes=x.element_size())
            b_ms, b_by = hardware.bound_ms(nbytes, ops, int8=True)
            label = f"{name}_M{M}" + ("_f32" if dtype == torch.float32 else "")
            row = {"ms": k_ms, "bound_ms": b_ms}
            extra = ""
            if M <= 8 and dtype == torch.bfloat16:
                row["plain_ms"] = timer.ms(lambda: im.int8_w8a8_matmul_plain(x, q, scale), iters=5)
                # yardstick: cuBLAS int8 x int8 -> int32 on the quantized
                # rows, padded to _int_mm's least M (17)
                xq = torch.zeros((max(17, M), K_pad), dtype=torch.int8, device=dev)
                xq[:M, :K] = im.quantize_rows(x)[0]
                row["library_ms"] = timer.ms(lambda: torch._int_mm(xq, q))
                row["int8_matmul_ms"] = timer.ms(lambda: im.int8_matmul(x, q, scale))
                del xq
                extra = (f" plain_ms={row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                         f"int8_matmul_ms={row['int8_matmul_ms']:.4f}")
            log(f"  int8_w8a8_matmul {name:8s} M={M} K={K} F={F} x={str(dtype)[6:]}: bitwise={ok} "
                f"max|err|={err:.4g} kernel_ms={k_ms:.4f}{extra} bound_ms={b_ms:.4f} ({b_by}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int8_w8a8_matmul {label} differs from its plain version")
            agg["err"] = max(agg["err"], err)
            per_shape[label] = row
            if M == 8 and dtype == torch.bfloat16 and name != "lm_head":  # one layer at B=8
                for key in ("ms", "plain_ms", "library_ms", "int8_matmul_ms"):
                    agg[key] += row[key]
                agg["bytes"] += nbytes
                agg["flops"] += ops
        del q
    b_ms, b_by = hardware.bound_ms(agg["bytes"], agg["flops"], int8=True)
    results["int8_w8a8_matmul"] = {
        "max_abs_err": agg["err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": agg["library_ms"],
        "shape": "one layer's wqkv+wo+w_gateup+w_down at M=8, bf16 x, quantizer included",
        "int8_matmul_ms": agg["int8_matmul_ms"],  # the weight-only kernel on the same packs
        "per_shape": per_shape,
    }


def check_flash(timer, dev, gen, results) -> None:
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = worst_rel = 0.0
    for B, T in ((2, 512), (2, 300)):
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        out = fa.flash_attention_causal(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        # |out| < ~3; the kernel rounds the probabilities to bf16 before its
        # P.V product on the tensor cores (the plain version keeps them
        # f32), which can move an output in [2, 4) across a rounding
        # boundary: one bf16 step there is 2^-6 = 0.0156 (the f32 kernel's
        # worst was 0.0078, one step in [1, 2))
        tol = 2e-2
        # each query row (b, t, h) against 5 % of its own RMS: late rows
        # average hundreds of V rows, so their outputs are small. (Over a
        # whole (b, h) the RMS is set by those small rows while the largest
        # error is one bf16 step of an early O(1) row, so that measure sits
        # near 0.05 for any kernel that rounds like the plain version.)
        rel = _per_row_rel_err(out.flatten(0, 2), ref.flatten(0, 2))
        rel_tol = 0.05
        k_ms = timer.ms(lambda: fa.flash_attention_causal(q, k, v))
        p_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v), iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes, flops = hardware.flash_attention_cost(B, T, Hq, Hkv, D)
        b_ms, b_by = hardware.bound_ms(nbytes, flops)
        ok = err <= tol and rel <= rel_tol
        log(f"  flash_attention_causal B={B} T={T}: max|err|={err:.4g} tol={tol} "
            f"max per-row |err|/rms={rel:.4g} tol={rel_tol} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_causal T={T} disagrees with its plain version")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
        if T == 512:
            results["flash_attention_causal"] = {
                "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms,
                "shape": "B=2 T=512 Hq=32 Hkv=8 D=128",
            }
    results["flash_attention_causal"]["max_abs_err"] = worst
    results["flash_attention_causal"]["max_rel_err"] = worst_rel


def check_decode(timer, dev, gen, results) -> None:
    """decode_attention over the fixed layout's int8 head-major cache at
    llama3-8b geometry and the engine's capacity (B=8, S=8192), for a
    ragged batch (one slot at 8191, six at 100-160, a dead slot at 0) and a
    uniform one (every slot at 2047), the smoke's serving traffic (seven
    slots at 100-220 and a dead slot) and slots ending on and just past the
    kernel's split boundaries."""
    from generativeaiexamples_tpu_torch.models.llama import PRESETS, quantize_kv

    cfg = PRESETS[MODEL]
    B, S = 8, 8192
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k_q, k_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    v_q, v_s = quantize_kv(torch.randn((B, Hkv, S, Dh), generator=gen, device=dev))
    k_s, v_s = k_s[:, :, None, :].contiguous(), v_s[:, :, None, :].contiguous()
    q = torch.randn((B, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
    # yardstick: SDPA over the dequantized bf16 strips with a length mask
    kd = (k_q.float() * k_s[:, :, 0, :, None]).to(torch.bfloat16)
    vd = (v_q.float() * v_s[:, :, 0, :, None]).to(torch.bfloat16)
    cases = {
        "ragged": [8191, 100, 112, 125, 131, 144, 160, 0],
        "uniform": [2047] * B,
        "short": [100, 131, 157, 0, 176, 199, 220, 143],
        "split_edge": [511, 512, 1023, 1024, 4095, 4096, 8191, 0],
    }
    out_rows = {}
    for case, positions in cases.items():
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        args = (q, k_q, k_s, v_q, v_s, pos)
        out = da.decode_attention(*args)
        ref = da.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        tol = 1e-2  # outputs are convex mixes of N(0, 1) rows; f32 inside, one bf16 rounding
        # each slot against its own size as well (a long strip's outputs
        # are ~sqrt(e / rows))
        rel = _per_row_rel_err(out, ref)
        rel_tol = 0.05
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"decode_attention[{case}] returned non-finite values")
        k_ms = timer.ms(lambda: da.decode_attention(*args))
        p_ms = timer.ms(lambda: da.decode_attention_plain(*args), iters=5)
        mask = (torch.arange(S, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
        l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], kd, vd, attn_mask=mask, enable_gqa=True))
        nbytes, flops = hardware.decode_attention_cost(positions, Hq, Hkv, Dh, S=S)
        b_ms, b_by = hardware.bound_ms(nbytes, flops)
        ok = err <= tol and rel <= rel_tol
        log(f"  decode_attention[{case}] B={B} S={S} positions={positions}: max|err|={err:.4g} "
            f"tol={tol} max per-slot |err|/rms={rel:.4g} tol={rel_tol} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention[{case}] disagrees with its plain version")
        out_rows[case] = {
            "max_abs_err": err, "max_rel_err": rel, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
        }
    del kd, vd
    results["decode_attention"] = {
        **out_rows["ragged"],
        "max_abs_err": max(r["max_abs_err"] for r in out_rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in out_rows.values()),
        "shape": "B=8 decode slots over an int8 fixed cache S=8192, Hq=32 Hkv=8 Dh=128, ragged "
                 "positions (8191, six at 100-160, a dead slot at 0)",
        **{case: {**out_rows[case], "positions": cases[case]} for case in cases if case != "ragged"},
    }


CHECKS = {"int8": check_int8, "w8a8": check_w8a8, "paged": check_paged, "flash": check_flash,
          "decode": check_decode}


def phase_kernels(dev, checks=tuple(CHECKS)) -> dict:
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict = {}
    one = torch.zeros(16, device=dev)
    log(f"  timer floor (one 16-element add_, the same timing): {timer.ms(lambda: one.add_(1)):.4f} ms")
    for name in checks:
        CHECKS[name](timer, dev, gen, results)
    del timer
    torch.cuda.empty_cache()
    log(f"  launches in this phase (checks and timing, not the serving path): {counts()}")
    log("phase kernels: ok")
    return results


# --------------------------------------------------------------------- #
# Phase 4: model level, kernel path against plain path

# Max |logits difference| allowed between the kernel path and the plain
# path: activations are bf16 through 32 layers, and the two paths round
# differently (the einsum reference rounds probabilities to bf16 before
# P.V, the kernels keep them in f32; split-K and tiled sums change f32
# order), a few bf16 ulps per layer on O(1) activations and logits.
# Under w8a8 the per-token int8 activations turn such a difference into a
# whole quantization step (1/127 of a row's absmax) wherever a rounding
# flips, so recipe B drifts most (0.35 against A's 0.10 on the H100); the
# greedy tokens must still agree wherever the top-2 margin exceeds the
# tolerance.
LOGITS_TOL = 0.5


def phase_model(dev) -> None:
    from generativeaiexamples_tpu_torch.models import llama
    from generativeaiexamples_tpu_torch.ops import quant

    t0 = time.time()
    cfg = llama.PRESETS[MODEL]
    page, steps = 128, 8
    lengths = [512, 300]
    B, T = len(lengths), 512
    gen = torch.Generator(device=dev).manual_seed(1)
    # one set of int8 packs serves every recipe (w8a8 runs on the same packs)
    params = quant.init_packed_params_int8(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    tokens = torch.randint(0, 512, (B, T), generator=gen, device=dev)
    lengths_d = torch.tensor(lengths, device=dev)
    per_row = -(-(T + steps) // page)
    tables = (1 + torch.arange(B * per_row, device=dev, dtype=torch.int32)).reshape(B, per_row)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    def run(quant_kernel, kv_dtype, kernels: bool, forced=None):
        pool = llama.init_kv_pool(
            cfg, 1 + B * per_row, page, torch.bfloat16, dev,
            quantized=kv_dtype != "bfloat16", packed=kv_dtype == "int4",
        )
        logits, kvs = llama.prefill_layers(
            params, cfg, tokens, lengths_d, use_flash=kernels, quant_kernel=quant_kernel
        )
        llama.write_prefill_pages(pool, kvs, tables, page)
        del kvs
        out = [logits]
        toks = []
        pos = lengths_d.clone()
        for s in range(steps):
            nxt = torch.argmax(out[-1], dim=-1) if forced is None else forced[s]
            toks.append(nxt)
            logits, _ = llama.decode_layers_paged(
                params, cfg, nxt, pos, live, tables, pool, window=per_row * page,
                page_size=page, quant_kernel=quant_kernel, page_kernel=kernels,
            )
            out.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        return torch.stack(out), toks

    S_fixed = per_row * page  # the fixed strips hold the same rows as a paged row
    slots = torch.arange(B, device=dev)

    def run_fixed(kernels: bool, forced=None):
        """The fixed layout with int8 weights and an int8 head-major cache
        read by decode_attention (kernel path) or decode_attention_xla
        (plain path)."""
        qk = None if kernels else False
        cache = llama.init_kv_cache_layers(cfg, B, S_fixed, torch.bfloat16, dev, quantized=True)
        logits, kvs = llama.prefill_layers(params, cfg, tokens, lengths_d, use_flash=kernels,
                                           quant_kernel=qk)
        llama.write_prefill_slots(cache, kvs, slots)
        del kvs
        out, toks, pos = [logits], [], lengths_d.clone()
        for s in range(steps):
            nxt = torch.argmax(out[-1], dim=-1) if forced is None else forced[s]
            toks.append(nxt)
            logits, _ = llama.decode_layers(params, cfg, nxt, pos, cache, window=S_fixed,
                                            quant_kernel=qk, kv_kernel=kernels)
            out.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        return torch.stack(out), toks

    def compare(label, k_logits, p_logits, t1):
        """Max |dlogits| within LOGITS_TOL, and the greedy tokens equal
        wherever the reference's top-2 margin exceeds it."""
        if not bool(torch.isfinite(k_logits).all()):
            raise AssertionError(f"{label}: non-finite logits")
        diff = float((k_logits - p_logits).abs().max())
        top2 = torch.topk(p_logits, 2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        agree = torch.argmax(k_logits, -1) == torch.argmax(p_logits, -1)
        bad = int(((margin > LOGITS_TOL) & ~agree).sum())
        log(f"  model {MODEL} (L={cfg.num_layers}, hidden {cfg.hidden_size}, vocab {cfg.vocab_size}), "
            f"{label}: prefill B={B} T={T} + {steps} decode steps: max|dlogits|={diff:.4g} "
            f"tol={LOGITS_TOL} greedy agree {int(agree.sum())}/{agree.numel()} (disagreements "
            f"where margin > tol: {bad}) logits shape {tuple(k_logits.shape)} "
            f"({time.time() - t1:.1f} s)")
        if diff > LOGITS_TOL or bad:
            raise AssertionError(f"{label}: the two paths disagree at model level")

    for name, quantization, kv_dtype, layout, _ in RECIPES:
        if layout != "paged":
            continue
        t1 = time.time()
        # quant_kernel values of the kernel path and of the plain path
        qk_kernel, qk_plain = ("w8a8", "w8a8_plain") if quantization == "w8a8" else (None, False)
        with torch.inference_mode():
            k_logits, k_toks = run(qk_kernel, kv_dtype, True)
            p_logits, _ = run(qk_plain, kv_dtype, False, forced=k_toks)  # same inputs at every step
        compare(f"recipe {name} ({quantization} weights, {kv_dtype} KV), kernel vs plain path",
                k_logits, p_logits, t1)
        del k_logits, p_logits

    with torch.inference_mode():
        t1 = time.time()
        f_logits, f_toks = run_fixed(True)
        p_logits, _ = run_fixed(False, forced=f_toks)
        compare("recipe D (int8 weights, int8 fixed cache), decode_attention kernel vs plain "
                "path", f_logits, p_logits, t1)
        t1 = time.time()
        g_logits, _ = run(None, "int8", True, forced=f_toks)
        compare("int8 weights + int8 KV, fixed layout kernel path vs paged layout kernel path",
                f_logits, g_logits, t1)
        del f_logits, p_logits, g_logits
    del params
    torch.cuda.empty_cache()
    log(f"phase model: ok ({time.time() - t0:.1f} s)")


# --------------------------------------------------------------------- #
# Phase 5: serve over HTTP


def _post(base, path, body, timeout=600):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def device_step_ms(engine) -> list:
    """Device times (sorted, ms) of five decode steps of the serving model at
    B=8 (kernel path, the engine's layout, KV dtype and quantization,
    160-token contexts), CUDA events around each step with a ~0.5 s spin
    kernel queued ahead and Python's collector off, so the host has enqueued
    the whole step before the device starts it: no launch gaps are timed.
    (torch.profiler does not see every launch of the ctypes-loaded kernels,
    so it is not used.)"""
    from generativeaiexamples_tpu_torch.models import llama

    cfg, dev, page = engine.model_config, engine.device, engine.engine_config.page_size
    B, per_row = engine.num_slots, 2
    tokens = torch.arange(B, device=dev) * 31 % 250
    positions = torch.full((B,), 160, device=dev)
    if engine._paged:
        pool = llama.init_kv_pool(
            cfg, 1 + B * per_row, page, torch.bfloat16, dev,
            quantized=engine._kv_quant, packed=engine._kv_packed,
        )
        tables = (1 + torch.arange(B * per_row, device=dev, dtype=torch.int32)).reshape(B, per_row)
        live = torch.ones(B, dtype=torch.bool, device=dev)

        def step():
            logits, _ = llama.decode_layers_paged(
                engine.params, cfg, tokens, positions, live, tables, pool,
                window=per_row * page, page_size=page, quant_kernel=engine._quant_kernel,
                page_kernel=True,
            )
            torch.argmax(logits, dim=-1)
    else:
        # per-slot strips of the same 256 rows; the decode kernel reads only
        # each slot's live rows, whatever the capacity
        cache = llama.init_kv_cache_layers(
            cfg, B, per_row * page, torch.bfloat16, dev, quantized=engine._kv_quant
        )

        def step():
            logits, _ = llama.decode_layers(
                engine.params, cfg, tokens, positions, cache, window=per_row * page,
                quant_kernel=engine._quant_kernel, kv_kernel=engine._kv_kernel,
            )
            torch.argmax(logits, dim=-1)

    times = []
    gc.disable()  # a collection mid-enqueue would outlast the spin and be timed
    try:
        with torch.inference_mode():
            step()
            for _ in range(5):
                torch.cuda._sleep(1_000_000_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            launches = launches_per_step(step)
    finally:
        gc.enable()
    return sorted(times), launches


# the port's kernels by the names of their __global__ functions (every
# W8A8 kernel name starts "w8a8_")
_PORT_KERNEL_NAMES = re.compile(
    r"int8_matmul_mma|w8a8_|paged_(split|merge)_kernel|flash_attention_kernel|decode_split_kernel")


def launches_per_step(step) -> dict:
    """Kernel launches of one decode step: those torch.profiler's device
    trace shows, split into PyTorch's and the port's, and the port's
    wrapper calls by their launch counts (the trace may miss launches from
    the ctypes-loaded libraries)."""
    from torch.profiler import ProfilerActivity, profile

    before = sum(counts().values())
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    except Exception as exc:  # noqa: BLE001 - a measurement, reported as not measured
        log(f"  launches per step: not measured ({exc!r})")
        return {}
    calls = sum(counts().values()) - before
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    port = sum(1 for n in names if _PORT_KERNEL_NAMES.search(n))
    return {"torch": len(names) - port, "port_seen": port, "port_calls": calls,
            "total": len(names) - port + max(port, calls)}


def _http_requests(engine, base) -> None:
    """Four concurrent requests over HTTP; every one must answer 200 with
    the OpenAI wire shape."""
    errors, results = [], {}

    def call(name, path, body):
        try:
            results[name] = _post(base, path, body)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc!r}")

    long_text = "Context: " + ("the quick brown fox jumps over the lazy dog. " * 16)
    requests = {
        "chat_stream": ("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Say hello."}],
            "stream": True, "max_tokens": 32, "temperature": 0.7, "seed": 7}),
        "chat": ("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "What is a GPU?"}],
            "max_tokens": 32, "temperature": 0}),
        "completions": ("/v1/completions", {
            "prompt": "Once upon a time", "max_tokens": 32, "temperature": 0}),
        "chat_long": ("/v1/chat/completions", {
            "messages": [{"role": "user", "content": long_text + "Summarize."}],
            "max_tokens": 24, "temperature": 0}),
    }
    threads = [
        threading.Thread(target=call, args=(n, p, b), name=f"smoke-{n}", daemon=True)
        for n, (p, b) in requests.items()
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if errors:
        raise AssertionError("; ".join(errors))
    for name, (status, text) in results.items():
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status}")
    frames = [ln[6:] for ln in results["chat_stream"][1].split("\n\n") if ln.startswith("data: ")]
    if not frames or frames[-1] != "[DONE]":
        raise AssertionError("SSE stream does not end in data: [DONE]")
    for fr in frames[:-1]:
        obj = json.loads(fr)
        assert obj["object"] == "chat.completion.chunk", obj
    assert json.loads(results["chat"][1])["choices"][0]["message"]["role"] == "assistant"
    assert json.loads(results["completions"][1])["object"] == "text_completion"
    long_ids = len(engine.tokenizer.render_chat([("user", long_text + "Summarize.")]))
    assert long_ids > engine.engine_config.prefill_chunk, long_ids
    log(f"  HTTP: chat stream {len(frames) - 1} chunks + [DONE], chat, completions, "
        f"long chat ({long_ids} prompt ids, chunked prefill): all 200")


class SyncCounter:
    """Counts PyTorch's synchronizing CUDA calls by thread name while it is
    entered: ``torch.cuda.set_sync_debug_mode("warn")`` makes each one (a
    blocking copy either way, ``.item()``, ``.cpu()``, a stream or device
    synchronize) warn in the thread that made it. Entering also checks
    that a probe thread's ``.item()`` is counted."""

    _MESSAGE = "synchronizing"

    def __enter__(self):
        self.counts = collections.Counter()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=f".*{self._MESSAGE}")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if self._MESSAGE in str(message):
                self.counts[threading.current_thread().name] += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        probe = threading.Thread(target=lambda: torch.ones(1, device="cuda").item(),
                                 name="smoke-sync-probe", daemon=True)
        probe.start()
        probe.join(60)
        if self.counts.pop("smoke-sync-probe", 0) < 1:
            self.__exit__(None, None, None)
            raise AssertionError("sync debug mode did not report a probe thread's .item()")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False


def check_wait_releases_the_gil() -> None:
    """The reader thread's wait (``torch.cuda.Event.synchronize``) must
    release the GIL, or the dispatch thread stalls behind it: a thread
    waits on an event queued behind a ~0.2 s spin kernel while this thread
    counts Python loop iterations, against its rate alone."""
    def spin(stop) -> float:
        """Python loop iterations a second until ``stop()``."""
        n, t0 = 0, time.perf_counter()
        while not stop():
            n += 1
        return n / (time.perf_counter() - t0)

    t_end = time.perf_counter() + 0.05
    alone = spin(lambda: time.perf_counter() >= t_end)
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    event = torch.cuda.Event()
    event.record()
    waited, done = {}, threading.Event()

    def wait():
        t0 = time.perf_counter()
        event.synchronize()
        waited["s"] = time.perf_counter() - t0
        done.set()

    thread = threading.Thread(target=wait, name="smoke-gil-probe", daemon=True)
    thread.start()
    during = spin(done.is_set)
    thread.join(60)
    share = during / alone
    log(f"  a thread's torch.cuda.Event.synchronize() waited {waited['s'] * 1e3:.1f} ms; "
        f"meanwhile this thread ran its Python loop at {share:.0%} of its rate alone "
        f"({'the wait releases the GIL' if share > 0.3 else 'the wait HOLDS the GIL'})")
    if waited["s"] < 0.05 or share <= 0.3:
        raise AssertionError("the reader's event wait does not release the GIL (or did not wait)")


def _drain_ids(q, timeout=600) -> list:
    out = []
    while (tok := q.get(timeout=timeout)) is not None:
        out.append(tok)
    return out


def check_runahead_and_overload(engine, config) -> dict:
    """A second engine on the same weights at decode_runahead 1, built with
    max_queued_requests = max_batch_size: one batch of 7 greedy rows and a
    seeded sampled row streams the same on both engines. Then, over HTTP,
    8 long requests fill its slots and 16 concurrent completions arrive:
    as many as fit wait and the rest answer 429 with Retry-After and
    X-GenAI-Queue-Depth; aborting the long requests lets the waiting ones
    answer 200."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    B = config.max_batch_size
    other = LLMEngine(dataclasses.replace(config, decode_runahead=1, max_queued_requests=B),
                      device=engine.device, params=engine.params)
    server = make_server("127.0.0.1", 0, engine=other)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http-overload", daemon=True)
    thread.start()
    try:
        prompts = [[256] + [(11 * i + j) % 250 for j in range(60 + 9 * i)] for i in range(B)]
        params = [SamplingParams(temperature=0.0, max_tokens=32)] * (B - 1) + [
            SamplingParams(temperature=0.8, top_p=0.9, max_tokens=32, seed=1234)]
        runs = []
        for eng in (engine, other):
            queues = [eng.generate_ids(p, sp) for p, sp in zip(prompts, params)]
            runs.append((eng.engine_config.decode_runahead, [_drain_ids(q) for q in queues]))
        (ra, a), (rb, b) = runs
        if a != b:
            raise AssertionError(f"streams differ between decode_runahead {ra} and {rb}")
        log(f"  runahead: {B} streams (7 greedy, 1 seeded sampled; lengths {[len(x) for x in a]}) "
            f"identical at decode_runahead {ra} and {rb}")

        hogs = [other.submit(p, SamplingParams(temperature=0.0, max_tokens=4000)) for p in prompts]
        deadline = time.time() + 120
        while (other.queue_depth() or len(other._slot_req) < B) and time.time() < deadline:
            time.sleep(0.01)
        base = f"http://127.0.0.1:{server.server_address[1]}"
        results = []

        def call(i):
            req = urllib.request.Request(
                base + "/v1/completions", headers={"Content-Type": "application/json"},
                data=json.dumps({"prompt": f"request {i}", "max_tokens": 8, "temperature": 0}).encode())
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    results.append((resp.status, dict(resp.headers)))
            except urllib.error.HTTPError as exc:
                results.append((exc.code, dict(exc.headers)))

        callers = [threading.Thread(target=call, args=(i,), name=f"smoke-overload-{i}", daemon=True)
                   for i in range(2 * B)]
        for c in callers:
            c.start()
        deadline = time.time() + 120
        while len(results) + other.queue_depth() < 2 * B and time.time() < deadline:
            time.sleep(0.01)
        depth = other.queue_depth()
        for h in hogs:
            other.abort(h)
        for c in callers:
            c.join(600)
        status = collections.Counter(code for code, _ in results)
        shed = [h for code, h in results if code == 429]
        headers_ok = all("Retry-After" in h and "X-GenAI-Queue-Depth" in h for h in shed)
        log(f"  overload over HTTP (max_queued_requests {B}, {B} slots held): {2 * B} concurrent "
            f"completions -> {dict(status)}, {depth} waited; every 429 with Retry-After and "
            f"X-GenAI-Queue-Depth: {headers_ok}")
        if not (status[429] >= 1 and status[200] >= 1 and status[429] + status[200] == 2 * B
                and headers_ok):
            raise AssertionError(f"overload over HTTP: {dict(status)}, headers {headers_ok}")
        return {"runahead_identical": True, "overload_status": dict(status)}
    finally:
        server.shutdown()
        server.server_close()
        other.shutdown()


def serve_recipe(dev, name, quantization, kv_dtype, layout, expected, http: bool,
                 runahead=None, extras=False) -> dict:
    """Build one engine, serve it (HTTP when ``http``, then 8 greedy
    generate_ids) counting each thread's synchronizing calls, and check
    that its path launched its kernels and its dispatch thread never
    waited for the card. Returns its decode metrics and the launch counts
    of its serving run. ``extras`` adds the runahead and overload checks."""
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    t0 = time.time()
    config = EngineConfig(model_config_name=MODEL, quantization=quantization,
                          kv_cache_dtype=kv_dtype, kv_layout=layout)
    if runahead is not None:
        config = dataclasses.replace(config, decode_runahead=runahead)
    engine = LLMEngine(config, device=dev)
    if engine._paged != (layout == "paged"):
        raise AssertionError(f"engine {name}: kv_layout={layout!r} did not resolve to {layout}")
    kv = (f"{kv_dtype} paged pool {engine._pool_pages} pages x {config.page_size}" if engine._paged
          else f"{kv_dtype} fixed cache {engine.num_slots} slots x {engine.max_seq_len} rows")
    log(f"  engine {name} built ({time.time() - t0:.1f} s): {MODEL} {quantization} weights, "
        f"{kv}, max_batch_size {config.max_batch_size}, prefill_chunk {config.prefill_chunk}, "
        f"decode_block {config.decode_block}, decode_runahead "
        f"{getattr(config, 'decode_runahead', 'none (synchronous decode)')}")
    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counts()
        t_serve = time.time()
        start = engine.stats()
        with SyncCounter() as syncs:
            if http:
                _http_requests(engine, base)

            # a full decode batch through the engine's own entry point, by ids
            before = engine.stats()
            prompts = [[256] + [(7 * i + j) % 250 for j in range(100 + 8 * i)] for i in range(8)]
            params = SamplingParams(temperature=0.0, max_tokens=64)
            t_batch = time.time()
            queues = [engine.generate_ids(p, params) for p in prompts]
            counts_ids = []
            for q in queues:
                n = 0
                while q.get(timeout=600) is not None:
                    n += 1
                counts_ids.append(n)
            batch_s = time.time() - t_batch
            after = engine.stats()
        launched = counts()
        stop_ids = set(engine.tokenizer.stop_ids())
        assert all(0 < n <= 64 for n in counts_ids), counts_ids
        t_total = time.time() - t_serve
        log(f"  engine {name} generate_ids x8 (greedy, max_tokens 64): ids per request "
            f"{counts_ids} (fewer than 64 only when a stop id {sorted(stop_ids)} was drawn) in "
            f"{batch_s:.3f} s from submit to the last end ({sum(counts_ids) / batch_s:.1f} ids/s)")
        log(f"  engine {name} launches while serving: {launched}")
        missing = [n for n in expected if launched[n] == 0]
        if missing:
            raise AssertionError(f"engine {name}: kernels never launched while serving: {missing}")
        blocks = after["decode_blocks"] - start.get("decode_blocks", 0)
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        reader_waits = after.get("readbacks", 0) - start.get("readbacks", 0)
        log(f"  engine {name} synchronizing calls while serving, by thread: "
            f"{dict(syncs.counts) or 'none'}; dispatch thread {dispatch_syncs} in "
            f"{blocks} decode blocks ({dispatch_syncs / max(blocks, 1):.2f} a block); reader "
            f"waits on events {reader_waits} (readbacks of {blocks} decode blocks and "
            f"{after['prefill_waves'] - start['prefill_waves']} prefill waves)")
        if _HAS_READER and dispatch_syncs:
            raise AssertionError(f"engine {name}: the dispatch thread waited for the card "
                                 f"{dispatch_syncs} times")
        d_rows = after["decode_rows"] - before.get("decode_rows", 0)
        d_time = after["decode_time_s"] - before.get("decode_time_s", 0.0)
        d_steps = after["decode_steps"] - before.get("decode_steps", 0)
        weight_bytes = hardware.streamed_weight_bytes(engine.params)
        serve = {
            "decode_tokens_per_s": d_rows / d_time,
            "decode_step_ms": 1e3 * d_time / d_steps,
            "decode_mfu": hardware.mfu_ratio(
                d_rows / d_time, hardware.matmul_params(engine.model_config)),
            "decode_weight_hbm_share": hardware.hbm_ratio(weight_bytes * d_steps / d_time),
            "ttft_mean_s": after.get("ttft_mean_s"),
            "ttft_max_s": after.get("ttft_max_s"),
            "launches": launched,
            "serve_s": t_total,
            # submit to the last end of the 8-request batch, prefill included
            "batch_s": batch_s,
            "batch_tokens_per_s": sum(counts_ids) / batch_s,
            "dispatch_syncs": dispatch_syncs,
            "dispatch_syncs_per_block": dispatch_syncs / max(blocks, 1),
            "reader_waits": reader_waits,
            "syncs_by_thread": dict(syncs.counts),
            "decode_blocks": blocks,
        }
        samples, serve["launches_per_step"] = device_step_ms(engine)
        serve["device_step_ms"] = statistics.median(samples)
        serve["device_step_ms_samples"] = samples
        serve["device_idle_share"] = max(0.0, 1.0 - serve["device_step_ms"] / serve["decode_step_ms"])
        log(f"  engine {name} decode at B=8: {serve['decode_tokens_per_s']:.1f} tokens/s, step "
            f"{serve['decode_step_ms']:.2f} ms (wall time of decode blocks, the engine's "
            f"decode_time_s); MFU {serve['decode_mfu']:.2%}, weight streaming at "
            f"{serve['decode_weight_hbm_share']:.1%} of peak HBM rate; one step on the device "
            f"{serve['device_step_ms']:.2f} ms (median of {', '.join(f'{t:.2f}' for t in samples)}; "
            f"idle {serve['device_idle_share']:.1%}); TTFT mean {serve['ttft_mean_s']:.3f} s "
            f"max {serve['ttft_max_s']:.3f} s over all requests; launches per decode step "
            f"{serve['launches_per_step'] or 'not measured'}")
        if extras:
            serve.update(check_runahead_and_overload(engine, config))
        return serve
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def phase_serve(dev, recipes="ABCD", runahead=None, extras=True) -> dict:
    t0 = time.time()
    serves = {}
    if _HAS_READER:
        check_wait_releases_the_gil()
    for name, quantization, kv_dtype, layout, expected in RECIPES:
        if name not in recipes:
            continue
        serves[name] = serve_recipe(dev, name, quantization, kv_dtype, layout, expected,
                                    http=name != "C", runahead=runahead,
                                    extras=extras and _HAS_READER and name == "A")
        gc.collect()  # the engine and its dispatch thread reference each other
        torch.cuda.empty_cache()
        log(f"  after engine {name}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    log(f"phase serve: ok ({time.time() - t0:.1f} s)")
    return serves


# --------------------------------------------------------------------- #
# Phase 6: the retrieval side of RAG (embedder, store, reranker, HTTP)

EMBED_MODEL, RERANK_MODEL = "arctic-embed-l", "arctic-embed-m"
# bounds, each from a CPU run of the same functions in bf16 against f32
# (cosine ~0.99993, max |d| ~1.8e-3, logits |d| ~8e-3 at full width)
CARD_VS_CPU_COS, CARD_VS_CPU_ABS, LOGIT_ABS = 0.999, 1e-2, 5e-2
# the batched path against the synchronous one, and a row alone against
# the same row in a batch, on one device: bitwise where both dispatch the
# same shapes; elsewhere cuBLAS tiles another shape differently, and one
# flipped bf16 rounding grows through 24 layers to the size of the bf16
# vs f32 difference (the card's first run: cosine 0.99990, max |d| 1.7e-3),
# so the same bounds hold
SAME_DEVICE_COS, SAME_DEVICE_ABS = CARD_VS_CPU_COS, CARD_VS_CPU_ABS
SEARCH_TOL = 1e-4  # f32 dot products of 1024-dim unit vectors, other sum orders


def _texts(rng, n, lo, hi) -> list:
    """``n`` passages of ``lo``-``hi`` byte-tokenizer ids (ASCII: one id a
    character), drawn from ``rng``."""
    alphabet = list("abcdefghijklmnopqrstuvwxyz     ")
    return ["".join(rng.choice(alphabet, int(n_ids))) for n_ids in rng.randint(lo, hi + 1, n)]


def _params_on(params, dev) -> int:
    """Tensors of a parameter tree; raises unless every one lives on ``dev``."""
    tensors = [t for k, t in params.items() if k != "layers"] + [
        t for lp in params["layers"] for t in lp.values()]
    off = [t.device for t in tensors if t.device.type != dev.type]
    if off:
        raise AssertionError(f"{len(off)} parameters off the card ({off[0]})")
    return sum(t.numel() for t in tensors)


def _cpu_f32(tree):
    from generativeaiexamples_tpu_torch.models.convert import _map

    return _map(tree, lambda t: t.detach().to("cpu", torch.float32))


def _pad(rows, T):
    import numpy as np

    ids = np.zeros((len(rows), T), np.int32)
    mask = np.zeros((len(rows), T), np.int32)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
        mask[i, : len(r)] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _row_stats(a, b):
    """(min cosine, max |a - b|, rows bitwise equal) of two [N, D] arrays."""
    import numpy as np

    cos = (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    same = int(sum(np.array_equal(x, y) for x, y in zip(a, b)))
    return float(cos.min()), float(np.abs(a - b).max()), same


def _check_topk(got_s, got_i, want_s, want_i, tol, what) -> None:
    """Scores within ``tol``; indices equal where the neighbours' scores
    are more than ``tol`` away (torch.topk orders ties as it likes)."""
    import numpy as np

    if np.abs(got_s - want_s).max() > tol:
        raise AssertionError(f"{what}: scores differ by {np.abs(got_s - want_s).max():.3g}")
    for r in range(want_s.shape[0]):
        k = want_s.shape[1]
        for j in range(k):
            gap = min(abs(want_s[r, j] - want_s[r, j - 1]) if j else np.inf,
                      abs(want_s[r, j] - want_s[r, j + 1]) if j + 1 < k else np.inf)
            if gap > tol and got_i[r, j] != want_i[r, j]:
                raise AssertionError(f"{what}: row {r} rank {j}: {got_i[r, j]} != {want_i[r, j]}")


def _profile_encode(emb, dev, R, T, smi) -> dict:
    """Where one encoder dispatch of ``R`` x ``T`` ids spends the card's
    time: torch.profiler's device events by kernel name (the top 6), the
    kernel count, and the host's wall time to enqueue the dispatch against
    the device's time for it."""
    from torch.profiler import ProfilerActivity, profile

    from generativeaiexamples_tpu_torch.models import bert

    ids = torch.randint(0, 256, (R, T), device=dev, dtype=torch.int32)
    mask = torch.ones((R, T), device=dev, dtype=torch.int32)
    with torch.inference_mode():
        bert.bert_encode(emb._params, emb._cfg, ids, mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bert.bert_encode(emb._params, emb._cfg, ids, mask)
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                bert.bert_encode(emb._params, emb._cfg, ids, mask)
                torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - a measurement, reported as not measured
            log(f"  profile {R}x{T}: not measured ({exc!r})")
            return {}
    by_name = collections.Counter()
    kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.device_time_total / 1e3
            kernels += 1
    total = sum(by_name.values())
    top = by_name.most_common(6)
    log(f"  profile of one {R}x{T} dispatch: {kernels} kernels, {total:.2f} ms of device time; "
        f"the host enqueues it in {enqueue_ms:.2f} ms; top: "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in top) + f" on {smi}")
    return {"kernels": kernels, "device_ms": total, "enqueue_ms": enqueue_ms,
            "top": [[n, ms] for n, ms in top]}


def phase_retrieval(dev, smi, seed=0) -> dict:
    """arctic-embed-l and arctic-embed-m at full width on the card (random
    weights from ``seed``): the card against the CPU's f32 plain path,
    batched against synchronous, a 65,536 x 1024 store searched exact and
    IVF against numpy, reranking, and /v1/embeddings beside a decoding
    engine A whose dispatch thread must make no synchronizing call."""
    import numpy as np

    from generativeaiexamples_tpu_torch.config import BatchingConfig
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker
    from generativeaiexamples_tpu_torch.models import bert
    from generativeaiexamples_tpu_torch.retrieval.store import Chunk
    from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore

    t0 = time.time()
    out = {}
    rng = np.random.RandomState(seed)
    timer = Timer(dev)

    # 1. both models on the card at full width
    emb = TorchEmbedder(model_name=EMBED_MODEL, batching=BatchingConfig(), device=dev, seed=seed)
    rr = TorchReranker(model_name=RERANK_MODEL, batching=BatchingConfig(), device=dev, seed=seed)
    try:
        ecfg, rcfg = emb._cfg, rr._cfg
        n_emb = _params_on(emb._params, dev)
        n_rr = _params_on(rr._params, dev) + sum(t.numel() for t in rr._head.values())
        if any(t.device.type != dev.type for t in rr._head.values()):
            raise AssertionError("the rank head is off the card")
        log(f"  {EMBED_MODEL}: {ecfg.num_layers} layers, hidden {ecfg.hidden_size}, "
            f"{ecfg.num_heads} heads, FFN {ecfg.intermediate_size}, {n_emb / 1e6:.1f} M parameters "
            f"({bert.matmul_params(ecfg) / 1e6:.1f} M in matmuls), bf16 on {dev}; {RERANK_MODEL}: "
            f"{rcfg.num_layers} layers, hidden {rcfg.hidden_size}, {n_rr / 1e6:.1f} M; random "
            f"weights (seed {seed}), byte tokenizer")

        # 2. the card (bf16) against the CPU (f32 plain path, same weights)
        texts4 = _texts(rng, 4, 64, 256)
        card = emb.embed_documents(texts4)
        rows4 = [emb._tok.encode(t) for t in texts4]
        ids, mask = _pad(rows4, max(len(r) for r in rows4))
        with torch.inference_mode():
            cpu = bert.bert_encode(_cpu_f32(emb._params), ecfg, ids, mask).numpy()
        cos = (card * cpu).sum(-1) / np.linalg.norm(card, axis=-1) / np.linalg.norm(cpu, axis=-1)
        err = float(np.abs(card - cpu).max())
        ok = cos.min() >= CARD_VS_CPU_COS and err <= CARD_VS_CPU_ABS
        log(f"  card (bf16) vs CPU (f32) on 4 passages of {[len(r) for r in rows4]} ids: cosine per "
            f"row {[round(float(c), 6) for c in cos]}, max|d| {err:.4g} (bounds: cosine >= "
            f"{CARD_VS_CPU_COS}, max|d| <= {CARD_VS_CPU_ABS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's embeddings disagree with the CPU's f32 plain path")
        out["card_vs_cpu"] = {"min_cos": float(cos.min()), "max_abs": err}

        # 3. 512 passages through the batched path, then the synchronous one
        texts = _texts(rng, 512, 32, 512)
        n_ids = sum(len(emb._tok.encode(t)) for t in texts)
        paths = {}
        for name, batched in (("batched", True), ("sync", False)):
            emb.set_batching(batched)
            before = emb.counters["device_dispatches"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vecs = emb.embed_documents(texts)
            wall = time.perf_counter() - t1
            paths[name] = (vecs, wall, emb.counters["device_dispatches"] - before)
        emb.set_batching(True)
        (vb, wb, db), (vs, ws, ds) = paths["batched"], paths["sync"]
        cos_bs, abs_bs, same_bs = _row_stats(vb, vs)
        # a row alone (1 row at its own bucket) against the same row in its batch of 32
        alone_idx = list(rng.choice(512, 8, replace=False))
        alone = np.stack([emb._dispatch_rows([emb._tok.encode(texts[i])], 1)[0] for i in alone_idx])
        cos_a, abs_a, same_a = _row_stats(alone, vb[alone_idx])
        ok = (same_bs == 512 or (cos_bs >= SAME_DEVICE_COS and abs_bs <= SAME_DEVICE_ABS)) and (
            same_a == 8 or (cos_a >= SAME_DEVICE_COS and abs_a <= SAME_DEVICE_ABS))
        log(f"  512 passages ({n_ids} ids, 32-512 each): batched {wb:.3f} s in {db} dispatches "
            f"({512 / wb:.1f} passages/s, {n_ids / wb:.0f} tokens/s), synchronous {ws:.3f} s in "
            f"{ds} dispatches ({512 / ws:.1f} passages/s, {n_ids / ws:.0f} tokens/s) on {smi}")
        log(f"  batched vs synchronous: {same_bs}/512 rows bitwise, min cosine {cos_bs:.7f}, max|d| "
            f"{abs_bs:.3g}; 8 rows alone vs in their batch of 32: {same_a}/8 bitwise, min cosine "
            f"{cos_a:.7f}, max|d| {abs_a:.3g} (bound when not bitwise: cosine >= {SAME_DEVICE_COS}, "
            f"max|d| <= {SAME_DEVICE_ABS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("batched and synchronous embeddings disagree")
        out["embed"] = {
            "passages": 512, "ids": n_ids, "batched_s": wb, "sync_s": ws,
            "batched_dispatches": db, "sync_dispatches": ds,
            "batched_passages_per_s": 512 / wb, "batched_tokens_per_s": n_ids / wb,
            "sync_passages_per_s": 512 / ws, "sync_tokens_per_s": n_ids / ws,
            "batched_vs_sync_bitwise_rows": same_bs, "batched_vs_sync_max_abs": abs_bs,
            "alone_vs_batch_bitwise_rows": same_a, "alone_vs_batch_max_abs": abs_a,
        }
        dispatch = {}
        for R, T in ((32, 512), (32, 128), (1, 64)):
            d_ids = torch.randint(0, 256, (R, T), device=dev, dtype=torch.int32)
            d_mask = torch.ones((R, T), device=dev, dtype=torch.int32)
            with torch.inference_mode():
                ms = timer.ms(lambda: bert.bert_encode(emb._params, ecfg, d_ids, d_mask), iters=10)
            flops = hardware.encoder_flops(ecfg, R, T)
            share = flops / (ms * 1e-3) / (hardware.PEAK_TFLOPS * 1e12)
            dispatch[f"{R}x{T}"] = {"ms": ms, "tflop": flops / 1e12, "peak_share": share}
            log(f"  embed dispatch ({R} rows x {T} ids): {ms:.3f} ms on the device (median of 10, "
                f"CUDA events), {flops / 1e12:.3f} TFLOP, {share:.1%} of the dense bf16 peak "
                f"({hardware.PEAK_TFLOPS:.0f} TFLOP/s) on {smi}")
        out["embed"]["dispatch"] = dispatch
        out["embed"]["profile"] = {
            shape: _profile_encode(emb, dev, R, T, smi) for shape, (R, T) in
            (("32x512", (32, 512)), ("1x64", (1, 64)))}

        # 4. a 65,536 x 1024 store: the 512 embeddings and seeded unit vectors
        N = 65536
        filler = rng.standard_normal((N - 512, ecfg.hidden_size)).astype(np.float32)
        filler /= np.linalg.norm(filler, axis=1, keepdims=True)
        corpus = np.concatenate([vb, filler])
        chunks = [Chunk(text=t, source=f"p{i}") for i, t in enumerate(texts)] + [
            Chunk(text=f"synthetic passage {i}", source="synthetic") for i in range(N - 512)]
        stores = {}
        for mode in ("exact", "ivf"):
            t1 = time.perf_counter()
            store = TorchVectorStore(ecfg.hidden_size, ann_mode=mode, nlist=64, nprobe=16, device=dev)
            store.add(chunks, corpus)
            store._ann_engine()
            stores[mode] = store
            log(f"  store[{mode}]: {store.count()} rows x {ecfg.hidden_size} f32 "
                f"({store._matrix.nbytes / 2**20:.0f} MiB) on the card in "
                f"{time.perf_counter() - t1:.2f} s (IVF: k-means on the host, nlist 64)")
        questions = [f"question {i}: " + t[:60] for i, t in enumerate(_texts(rng, 8, 40, 120))]
        queries = np.stack([emb.embed_query(q) for q in questions])
        matrix = stores["exact"]._matrix
        want_s = np.sort(matrix @ queries.T, axis=0)[::-1][:16].T
        want_i = np.argsort(-(matrix @ queries.T), axis=0, kind="stable")[:16].T
        ex_s, ex_i = stores["exact"]._ann.search(queries, 16)
        _check_topk(ex_s, ex_i, want_s, want_i, SEARCH_TOL, "exact search vs numpy")
        log(f"  exact search of 8 embed_query vectors, k 16: scores within "
            f"{float(np.abs(ex_s - want_s).max()):.3g} of numpy's brute force (limit {SEARCH_TOL}), "
            f"indices equal outside ties: ok")
        iv_s, iv_i = stores["ivf"]._ann.search(queries, 16)
        recall = {k: float(np.mean([len(set(iv_i[r, :k]) & set(ex_i[r, :k])) / k
                                    for r in range(8)])) for k in (4, 16)}
        search_ms = {}
        for mode, store in stores.items():
            eng = store._ann
            corp = eng._corpus
            nprobe = min(16, corp.centroids.shape[0]) if mode == "ivf" else 0
            for R in (1, 8):
                q_dev = torch.from_numpy(np.ascontiguousarray(queries[:R])).to(dev)
                for k in (4, 16):
                    with torch.inference_mode():
                        ms = timer.ms(lambda: eng._topk(corp, q_dev, k, nprobe))
                    t1 = time.perf_counter()
                    for _ in range(5):
                        store.search_batch(queries[:R], k)
                    wall = (time.perf_counter() - t1) / 5 * 1e3
                    b_ms, b_by = hardware.bound_ms(*hardware.search_cost(
                        R, corp.capacity, ecfg.hidden_size, 64 if mode == "ivf" else 0))
                    search_ms[f"{mode}_r{R}_k{k}"] = {"ms": ms, "wall_ms": wall, "bound_ms": b_ms}
                    log(f"  search[{mode}] rows {R} k {k}: {ms:.4f} ms on the device, "
                        f"{wall:.3f} ms wall for store.search_batch, bound {b_ms:.4f} ms ({b_by}) "
                        f"on {smi}")
        log(f"  IVF (nlist 64, nprobe 16) recall against exact: @4 {recall[4]:.3f}, @16 "
            f"{recall[16]:.3f}")
        out["search"] = {"ms": search_ms, "ivf_recall": recall}

        # 5. rerank each query's top 16
        rerank_ms = []
        first_pairs = None
        for r, q in enumerate(questions):
            passages = [chunks[int(i)].text for i in ex_i[r]]
            t1 = time.perf_counter()
            logits = rr.score(q, passages)
            rerank_ms.append((time.perf_counter() - t1) * 1e3)
            if r == 0:
                first_pairs, first_logits = rr._tokenize_pairs(q, passages), logits
        T = max(len(p[0]) for p in first_pairs)
        ids, mask = _pad([p[0] for p in first_pairs], T)
        types, _ = _pad([p[1] for p in first_pairs], T)
        with torch.inference_mode():
            cpu_logits = bert.cross_encode_score(
                _cpu_f32(rr._params), {k: v.to("cpu", torch.float32) for k, v in rr._head.items()},
                rcfg, ids, mask, types).numpy()
        lerr = float(np.abs(first_logits - cpu_logits).max())
        ok = lerr <= LOGIT_ABS and bool(np.isfinite(first_logits).all())
        log(f"  rerank top 16 of each of 8 queries: {statistics.median(rerank_ms):.2f} ms median "
            f"wall a query ({', '.join(f'{m:.1f}' for m in rerank_ms)}), on {smi}; card vs CPU f32 "
            f"logits on query 0: max|d| {lerr:.4g} (limit {LOGIT_ABS}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the card's rerank logits disagree with the CPU's f32 plain path")
        out["rerank"] = {"ms_median": statistics.median(rerank_ms), "ms": rerank_ms,
                         "max_abs_logit": lerr}
        del stores, corpus, filler
        gc.collect()

        # 6. over HTTP beside a decoding engine A
        out["http"] = _retrieval_http(dev, emb, rng, smi)
    finally:
        emb.close()
        rr.close()
    log(f"phase retrieval: ok ({time.time() - t0:.1f} s)")
    return out


def _retrieval_http(dev, emb, rng, smi) -> dict:
    """Engine A's weights behind the server with ``emb``: /v1/embeddings
    and /v1/models, then an ingest of 64 passages and three embed_query
    calls while 8 greedy requests decode, counting each thread's
    synchronizing calls."""
    import numpy as np

    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    engine = LLMEngine(EngineConfig(model_config_name=MODEL, quantization="int8",
                                    kv_cache_dtype="bfloat16", kv_layout="paged"), device=dev)
    server = make_server("127.0.0.1", 0, engine=engine, embedder=emb)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http-retrieval", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        texts = _texts(rng, 3, 40, 200)
        status, text = _post(base, "/v1/embeddings", {"input": texts})
        body = json.loads(text)
        vecs = np.asarray([d["embedding"] for d in body["data"]], np.float32)
        direct = emb.embed_documents(texts)
        cos, err, same = _row_stats(vecs, direct)
        norms = np.linalg.norm(vecs, axis=1)
        ok = (status == 200 and vecs.shape == (3, emb.dimensions) and np.abs(norms - 1).max() <= 1e-5
              and (same == 3 or (cos >= SAME_DEVICE_COS and err <= SAME_DEVICE_ABS)))
        with urllib.request.urlopen(base + "/v1/models", timeout=60) as resp:
            models = [m["id"] for m in json.loads(resp.read())["data"]]
        log(f"  POST /v1/embeddings (3 inputs): HTTP {status}, {vecs.shape[1]} dims, norms "
            f"{[round(float(n), 6) for n in norms]}, against embed_documents: {same}/3 bitwise, "
            f"max|d| {err:.3g}; /v1/models {models} {'ok' if ok else 'FAIL'}")
        if not ok or models != ["torch-llama", "torch-arctic-embed"]:
            raise AssertionError("/v1/embeddings or /v1/models is wrong")

        with llm_engine._ENGINE_LOCK:
            llm_engine._ENGINE = engine  # the process engine the ingest gate asks
        try:
            gate0 = dict(emb._batcher.counters)
            with SyncCounter() as syncs:
                prompts = [[256] + [(5 * i + j) % 250 for j in range(90 + 9 * i)] for i in range(8)]
                queues = [engine.generate_ids(p, SamplingParams(temperature=0.0, max_tokens=64))
                          for p in prompts]
                deadline = time.time() + 120
                while not engine.is_decoding() and time.time() < deadline:
                    time.sleep(0.005)
                ingest = {}
                passages = _texts(rng, 64, 32, 512)

                def run_ingest():
                    t1 = time.perf_counter()
                    ingest["vecs"] = emb.embed_documents(passages)
                    ingest["s"] = time.perf_counter() - t1

                th = threading.Thread(target=run_ingest, name="smoke-ingest", daemon=True)
                th.start()
                query_ms, while_decoding = [], []
                for i in range(3):
                    emb.clear_query_cache()
                    t1 = time.perf_counter()
                    emb.embed_query(f"a live question number {i} about the corpus")
                    query_ms.append((time.perf_counter() - t1) * 1e3)
                    while_decoding.append(engine.is_decoding())
                th.join(600)
                n_ids = [len(_drain_ids(q)) for q in queues]
        finally:
            with llm_engine._ENGINE_LOCK:
                llm_engine._ENGINE = None
        counters = emb._batcher.counters
        gated = counters["ingest_gated_batches"] - gate0.get("ingest_gated_batches", 0)
        waited = counters["ingest_gate_wait_s"] - gate0.get("ingest_gate_wait_s", 0.0)
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        log(f"  while 8 greedy requests decoded ({n_ids} ids): an ingest of 64 passages (2 "
            f"batches) took {ingest.get('s', float('nan')):.3f} s and waited on ingest_window "
            f"{gated} times (a batch a query preempted waits again), {waited * 1e3:.1f} ms in "
            f"all; 3 embed_query calls "
            f"{[round(m, 2) for m in query_ms]} ms (engine decoding at each return: "
            f"{while_decoding}; the query lane has no gate); synchronizing calls by thread: "
            f"{dict(syncs.counts)} on {smi}")
        if "vecs" not in ingest or ingest["vecs"].shape != (64, emb.dimensions):
            raise AssertionError("the ingest during decode did not finish")
        if gated < 1:
            raise AssertionError("no ingest batch waited on ingest_window while the engine decoded")
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while embeddings ran")
        return {"status": status, "ingest_s": ingest["s"], "ingest_gated_batches": gated,
                "ingest_gate_wait_ms": waited * 1e3, "query_ms": query_ms,
                "query_while_decoding": while_decoding, "dispatch_syncs": dispatch_syncs,
                "syncs_by_thread": dict(syncs.counts)}
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="kernels,model,serve,retrieval",
                        help="phases after the build, comma-separated (default: all)")
    parser.add_argument("--checks", default=",".join(CHECKS),
                        help="phase 3's kernel checks, comma-separated (default: all)")
    parser.add_argument("--recipes", default="ABCD", help="phase 5's engines (default: ABCD)")
    parser.add_argument("--runahead", type=int, default=None,
                        help="decode_runahead of phase 5's engines (default: the config's)")
    parser.add_argument("--timing-only", action="store_true",
                        help="leave out phase 5's runahead and overload checks")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase 6's weights and passages (default: 0)")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t0 = time.time()
    info = phase_device()
    phase_build()
    results = phase_kernels(dev, args.checks.split(",")) if "kernels" in phases else {}
    if "model" in phases:
        phase_model(dev)
    serves = (phase_serve(dev, args.recipes, args.runahead, not args.timing_only)
              if "serve" in phases else {})
    retrieval = phase_retrieval(dev, info["smi"], args.seed) if "retrieval" in phases else {}
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        if name not in results:  # a check left out by --checks
            continue
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(sv["launches"][name] for sv in serves.values()), **r,
        })
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "serve": {
        name: {k: v for k, v in sv.items() if k != "launches"} for name, sv in serves.items()
    }, "retrieval": retrieval}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
