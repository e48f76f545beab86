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
7. rag: ``developer_rag`` end to end through the port's chain server
   (``server/api.py``) on an ephemeral port, everything built by the
   port's factories from the JAX config's ``APP_*`` names (``RAG_ENV``):
   engine A (llama3-8b, int8 weights, bf16 paged pool, ``max_batch_size``
   8, ``max_seq_len`` 8192, ``prefill_chunk`` 512) through ``create_llm``,
   phase 6's arctic-embed-l and arctic-embed-m (or the factories' own when
   phase 6 does not run), a store under a temporary ``persist_dir``,
   ``ranked_hybrid``. 16 seeded documents (13 .txt, 2 .md, 1 .pdf) over
   ``POST /documents`` and listed by ``GET /documents``; ``POST /search``
   with a sentence of each of 8 documents finds that document first, and
   its top 4 equal the port's runtime on the CPU in f32 (near-ties of the
   reranker exempt); 8 concurrent ``/generate`` over the knowledge base and
   one without stream to ``[DONE]``, none a no-context answer, each prompt
   the engine received holding its top hit, ``int8_matmul``,
   ``paged_attention`` and ``flash_attention_causal`` launched and no
   synchronizing call on the LLM dispatch thread; a second round traced for
   the device's idle share; ``DELETE /documents`` drops a document from the
   store and BM25; ``deadline_ms`` 1 answers 504. It prints ingest s a
   document, /search ms, TTFT with its retrieval ms, prompt ids, decode
   tokens/s and the idle share, and the prefix cache's hits and misses
   (the engine serves at the JAX default, ``prefix_cache_enable`` auto).
8. chains: the text chains through the port's chain server, each picked
   through the registry, on phase 7's deployment (its engine A, encoders
   and ``default`` collection; alone, it builds them and ingests phase 7's
   16 documents), every engine request sampling from one seed:
   ``simple_rag`` ingests the 16 documents into its own collection over
   ``POST /documents`` (2000-character chunks, store and BM25), ``/search``
   finds a document's sentence in that document first, and 4 concurrent
   ``/generate`` (each of sentences of 4 documents) answer 200 with no
   warning; ``multi_turn`` runs 4 concurrent conversations of 3 turns with
   the history in ``messages``, after which ``conv_store`` holds 24 chunks
   in the store and BM25 and each first question retrieves its "User
   previously responded with ..." memory; 2 concurrent
   ``query_decomposition`` answers make at least 3 engine requests each
   (the engine's ``requests_prefilled``); ``api_catalog`` answers one
   ``/generate`` through the in-process backend, then the same through
   ``RemoteLLMBackend`` and the port's engine server on engine A: the
   engine gets the same prompt ids and both streams are the same text.
   ``int8_matmul``, ``paged_attention`` and ``flash_attention_causal`` are
   launched and the LLM dispatch thread makes no synchronizing call. It
   prints TTFT (mean, max) and prompt ids by chain, engine requests an
   answer, the launches, the prefix cache's hits and misses and the
   phase's wall seconds.
9. prefix: the automatic prefix KV cache on recipes A (shared pool pages)
   and D (a store of int8 strips and one copy a hit), llama3-8b at full
   width and depth, random weights (seed 0), the engine defaults
   otherwise (``prefill_chunk`` 512, ``page_size`` 128,
   ``decode_runahead`` 4). The JAX bench's shared-prefix pass: one
   preamble of 4 chunks (2048 ids), 16 distinct questions of 128 ids, 16
   greedy tokens, one request at a time, through an engine with
   ``prefix_cache_enable`` off (the cold streams) and then, on the same
   weights, an engine at the default ``auto`` (the warm ones). Every warm
   stream equals its cold one; 1 miss and 15 hits; a warm request
   dispatches 1 prefill chunk where a cold one dispatches 5; D makes 16
   store copies (1 insert, 15 fetches), A none and maps 15 x 16 pages; on
   A the donor's pages hold the same bits after the 16 decodes and the
   pages in use are the entries'; 0 synchronizing calls on the dispatch
   thread; then one held wave of a warm row, a cold 1.5k-id row and a
   300-id row, each equal to its cold reference or parting from it only
   at a token whose top-1 margin is within ``LOGITS_TOL`` (printed). It
   prints cold and warm TTFT (p50, max), the chunks, hits, misses, tokens
   reused and the pool or store size.

With no arguments it runs every phase, as above; ``--phases``,
``--checks`` and ``--recipes`` run a part (for example ``--phases serve
--recipes B``, ``--phases chains`` or ``--phases prefix``) and then print only the kernels that part measured;
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

from generativeaiexamples_tpu_torch.config import EngineConfig
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
_HAS_READER = "decode_runahead" in EngineConfig.__dataclass_fields__
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


def phase_retrieval(dev, smi, seed=0, keep=False):
    """arctic-embed-l and arctic-embed-m at full width on the card (random
    weights from ``seed``): the card against the CPU's f32 plain path,
    batched against synchronous, a 65,536 x 1024 store searched exact and
    IVF against numpy, reranking, and /v1/embeddings beside a decoding
    engine A whose dispatch thread must make no synchronizing call.
    Returns the results and, when ``keep``, the (embedder, reranker) pair
    still open for phase 7 (else None)."""
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
        if not keep or sys.exc_info()[0] is not None:
            emb.close()
            rr.close()
    log(f"phase retrieval: ok ({time.time() - t0:.1f} s)")
    return out, ((emb, rr) if keep else None)


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


# --------------------------------------------------------------------- #
# Phase 7: developer_rag end to end through the chain server

RAG_DOCS, RAG_QUERIES, RAG_WORDS = 16, 8, 24
# The phase's deployment, read through the JAX config's APP_* names by the
# port's own factories (config.get_config, chains.runtime, create_llm,
# create_embedder, create_reranker). Two values differ from the JAX defaults,
# both because the encoders' weights are random:
# - APP_RETRIEVER_SCORETHRESHOLD=1.0: a random arctic-embed-l's cosine says
#   nothing of relevance, so no dense hit passes (a clamped cosine of two
#   different texts stays below 1.0); the dense leg still embeds every query
#   and searches the store on the card, and BM25 over per-document
#   vocabularies gives the candidates: exactly the chunks of the document a
#   query sentence was taken from;
# - APP_TEXTSPLITTER_CHUNKSIZE=48, CHUNKOVERLAP=16 (JAX: 510, 200 words): a
#   document of 100-150 words then makes 4-5 chunks, so each query has
#   several candidates and the random arctic-embed-m reranker orders them
#   (at 510 words a document is one chunk, and one candidate is never
#   reranked). Its order is arbitrary but held against the CPU's f32.
RAG_ENV = {
    "EXAMPLE_NAME": "developer_rag",
    "APP_LLM_MODELENGINE": "tpu",
    "APP_EMBEDDINGS_MODELENGINE": "tpu",
    "APP_RANKING_MODELENGINE": "tpu",
    "APP_ENGINE_MODELCONFIGNAME": MODEL,
    "APP_ENGINE_QUANTIZATION": "int8",
    "APP_ENGINE_KVCACHEDTYPE": "bfloat16",
    "APP_ENGINE_KVLAYOUT": "paged",
    "APP_RETRIEVER_NRPIPELINE": "ranked_hybrid",
    "APP_RETRIEVER_SCORETHRESHOLD": "1.0",
    "APP_TEXTSPLITTER_CHUNKSIZE": "48",
    "APP_TEXTSPLITTER_CHUNKOVERLAP": "16",
}
RAG_EXPECTED = ("int8_matmul", "paged_attention[bfloat16]", "flash_attention_causal")
# phase 8's split topology: api_catalog answering through RemoteLLMBackend
# (APP_LLM_SERVERURL is the engine server's address, known once it listens)
REMOTE_LLM_ENV = {"EXAMPLE_NAME": "api_catalog", "APP_LLM_MODELENGINE": "remote"}


def _rag_corpus(rng):
    """RAG_DOCS documents of 100-150 words, each from its own vocabulary of
    RAG_WORDS seeded pseudo-words, as lists of sentences (8-12 words, a
    period each)."""
    letters = list("abcdefghijklmnopqrstuvwxyz")
    words = set()
    while len(words) < RAG_DOCS * RAG_WORDS:
        words.add("".join(rng.choice(letters, int(rng.randint(4, 10)))))
    words = sorted(words)
    rng.shuffle(words)
    docs = []
    for d in range(RAG_DOCS):
        vocab = words[d * RAG_WORDS:(d + 1) * RAG_WORDS]
        target, sentences, n = int(rng.randint(100, 151)), [], 0
        while n < target:
            k = min(int(rng.randint(8, 13)), target - n) if target - n >= 8 else target - n
            sentences.append(" ".join(rng.choice(vocab, k)) + ".")
            n += k
        docs.append(sentences)
    return docs


def _rag_files(docs):
    """(filename, bytes) per document: 13 .txt, 2 .md and 1 .pdf."""
    from generativeaiexamples_tpu_torch.retrieval.pdf import write_text_pdf

    files = []
    for d, sentences in enumerate(docs):
        if d == RAG_DOCS - 1:
            files.append((f"doc{d:02d}.pdf", write_text_pdf(sentences)))
        elif d >= RAG_DOCS - 3:
            body = f"# Notes {d}\n\n" + " ".join(sentences[:3]) + "\n\n" + " ".join(sentences[3:])
            files.append((f"doc{d:02d}.md", body.encode()))
        else:
            files.append((f"doc{d:02d}.txt", " ".join(sentences).encode()))
    return files


def _multipart(filename, data):
    boundary = "chipsmokeboundary7"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream\r\n\r\n").encode()
    return body + data + f"\r\n--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def _http(base, method, path, body=None, raw=None, ctype="application/json", timeout=600):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype} if data is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _generate_stream(base, query, kb, max_tokens=64, history=()):
    """One streamed /generate, ``history`` (role, content) pairs before the
    query: (frames, seconds to the first answer frame (the [DONE] frame
    when no text came), seconds to the end)."""
    messages = [{"role": r, "content": c} for r, c in history]
    body = {"messages": messages + [{"role": "user", "content": query}],
            "use_knowledge_base": kb, "max_tokens": max_tokens}
    req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    frames, first = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"/generate: HTTP {resp.status}")
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if not line:
                continue
            if not line.startswith("data: "):
                raise AssertionError(f"/generate: not an SSE data line: {line[:80]!r}")
            frame = json.loads(line[6:])
            frames.append(frame)
            choice = (frame.get("choices") or [{}])[0]
            if first is None and (choice.get("message", {}).get("content")
                                  or choice.get("finish_reason") == "[DONE]"):
                first = time.perf_counter() - t0
    return frames, first, time.perf_counter() - t0


class _RecordingEngine:
    """Engine A behind a recorder of the prompt ids it is handed (what the
    chain's backend renders, or the engine server's ``chat`` route); with
    ``seed``, every request samples from that seed. Everything else goes
    to the engine."""

    def __init__(self, engine, seed=None):
        self._engine = engine
        self.tokenizer = engine.tokenizer
        self.seed = seed
        self.prompts = []
        self._lock = threading.Lock()

    def stream_text(self, prompt_ids, params=None, timeout=None):
        if self.seed is not None:
            params = dataclasses.replace(params, seed=self.seed)
        with self._lock:
            self.prompts.append(list(prompt_ids))
        return self._engine.stream_text(prompt_ids, params, timeout=timeout)

    def chat(self, messages, params=None):
        return self.stream_text(self.tokenizer.render_chat(messages), params)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _prefix_counts(before, after) -> dict:
    """The prefix cache's hits and misses between two ``engine.stats()``
    (the chains' preambles are shorter than a prefill chunk: few hits)."""
    return {k: after.get("prefix_cache_" + k, 0) - before.get("prefix_cache_" + k, 0)
            for k in ("hits", "misses")}


def _device_spans(prof) -> list:
    """(start, end) in microseconds of every device event of a finished
    torch.profiler trace, from its raw Kineto events (building the
    FunctionEvent tree takes minutes for a few hundred thousand)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]


def _busy_ms(spans) -> float:
    """Length of the union of the intervals ``spans`` (us), in ms."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def _rag_deploy(encoders=None) -> dict:
    """Phase 7's deployment (``RAG_ENV``) under a temporary store and
    upload directory, built by the port's factories: the embedder and the
    reranker (``encoders``, phase 6's pair, put in the factories' caches
    instead of building a second pair) and engine A through ``create_llm``.
    ``_rag_teardown`` undoes it."""
    import os
    import tempfile

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import embedder as emb_mod
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine import reranker as rr_mod
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rag_")
    env = dict(RAG_ENV, APP_VECTORSTORE_PERSISTDIR=os.path.join(tmp, "store"),
               DOC_UPLOAD_DIR=os.path.join(tmp, "uploads"))
    dep = {"tmp": tmp, "saved_env": {k: os.environ.get(k) for k in
                                     list(env) + ["APP_LLM_SERVERURL"]}}
    os.environ.update(env)
    runtime.reset_runtime()
    runtime.set_device(None)
    try:
        config = config_mod.get_config()
        dep["emb_key"] = (config.embeddings.model_engine, config.embeddings.server_url,
                          config.embeddings.model_name, "None")
        dep["rr_key"] = (config.ranking.model_engine, config.ranking.server_url,
                         config.ranking.model_name, "None")
        if encoders is not None:  # phase 6's pair: the same models, seed and batching
            emb_mod._EMBEDDER_CACHE[dep["emb_key"]], rr_mod._RERANKER_CACHE[dep["rr_key"]] = \
                encoders
        emb, rr = runtime.get_embedder(config), runtime.resolve_pipeline(config, 4)[2]
        if not isinstance(emb, TorchEmbedder) or not isinstance(rr, TorchReranker):
            raise AssertionError(f"the factories built {type(emb).__name__}, {type(rr).__name__}")
        if emb._params["tok_embed"].device.type != "cuda" or rr._head["w"].device.type != "cuda":
            raise AssertionError("the embedder or the reranker is off the card")
        t1 = time.time()
        engine = runtime.get_llm(config)._engine
        if engine is not llm_engine._ENGINE or engine.device.type != "cuda" or not engine._paged:
            raise AssertionError("create_llm did not build the process engine on the card, paged")
    except BaseException:
        _rag_teardown(dep)
        raise
    dep.update(config=config, emb=emb, rr=rr, engine=engine, engine_s=time.time() - t1)
    return dep


def _rag_teardown(dep) -> None:
    """Shut engine A down, close the encoders, restore the environment and
    remove the temporary directory."""
    import os
    import shutil

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine import llm_engine

    eng = llm_engine._ENGINE
    if eng is not None:
        eng.shutdown()
    with llm_engine._ENGINE_LOCK:
        llm_engine._ENGINE = None
    runtime.reset_runtime()  # closes the encoders' batcher threads
    for key, value in dep["saved_env"].items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    config_mod.get_config.cache_clear()
    shutil.rmtree(dep["tmp"], ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def phase_rag(dev, smi, seed=0, encoders=None, keep=False):
    """developer_rag through the port's chain server on the card (module
    docstring, phase 7). ``encoders``: phase 6's (embedder, reranker), put
    in the factories' caches instead of building a second pair. Returns the
    results and, when ``keep``, the deployment still up, its engine,
    encoders and stores, for phase 8 (else None)."""
    import numpy as np

    from generativeaiexamples_tpu_torch.chains import developer_rag, runtime
    from generativeaiexamples_tpu_torch.config import BatchingConfig
    from generativeaiexamples_tpu_torch.engine import embedder as emb_mod
    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.engine import reranker as rr_mod
    from generativeaiexamples_tpu_torch.engine.embedder import TorchEmbedder
    from generativeaiexamples_tpu_torch.engine.reranker import TorchReranker
    from generativeaiexamples_tpu_torch.retrieval.torch_store import TorchVectorStore
    from generativeaiexamples_tpu_torch.server.api import make_server

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    rng = np.random.RandomState(seed + 7)
    dep = _rag_deploy(encoders)
    config, emb, rr, engine = dep["config"], dep["emb"], dep["rr"], dep["engine"]
    emb_key, rr_key = dep["emb_key"], dep["rr_key"]
    server = thread = None
    out = {}
    orig_retrieve = runtime.retrieve
    try:
        recorder = _RecordingEngine(engine)
        llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
        llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(engine=recorder)
        ec = engine.engine_config
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s): {ec.model_config_name} "
            f"{ec.quantization} weights, {ec.kv_cache_dtype} paged pool, max_batch_size "
            f"{ec.max_batch_size}, max_seq_len {ec.max_seq_len}, prefill_chunk {ec.prefill_chunk} "
            f"(random weights, seed 0); {EMBED_MODEL} and {RERANK_MODEL} "
            f"{'from phase 6' if encoders is not None else 'built by the factories'}; "
            f"nr_pipeline {config.retriever.nr_pipeline}, score_threshold "
            f"{config.retriever.score_threshold}, chunks {config.text_splitter.chunk_size}/"
            f"{config.text_splitter.chunk_overlap} words")

        retrieved = {}

        def timed_retrieve(query, *args, **kwargs):
            t = time.perf_counter()
            hits = orig_retrieve(query, *args, **kwargs)
            retrieved[query] = (hits, (time.perf_counter() - t) * 1e3)
            return hits

        runtime.retrieve = timed_retrieve
        server = make_server("127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, name="smoke-chain-server",
                                  daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, text = _http(base, "GET", "/health")
        if status != 200 or json.loads(text) != {"message": "Service is up."}:
            raise AssertionError(f"/health: {status} {text}")

        # 1-2. ingest 16 documents, list them
        docs = _rag_corpus(rng)
        files = _rag_files(docs)
        ingest_s = []
        for name, data in files:
            raw, ctype = _multipart(name, data)
            t1 = time.perf_counter()
            status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
            ingest_s.append(time.perf_counter() - t1)
            if status != 200 or json.loads(text) != {"message": "File uploaded successfully"}:
                raise AssertionError(f"POST /documents {name}: {status} {text}")
        status, text = _http(base, "GET", "/documents")
        listed = json.loads(text)["documents"]
        names = [n for n, _ in files]
        if status != 200 or sorted(listed) != sorted(names):
            raise AssertionError(f"GET /documents: {status} {listed}")
        n_chunks = runtime.get_vector_store("default").count()
        if runtime.get_bm25_index("default").count() != n_chunks:
            raise AssertionError("the store and BM25 hold different chunk counts")
        note(f"ingest over POST /documents: {len(files)} documents (13 .txt, 2 .md, 1 .pdf; "
            f"{sum(len(' '.join(d).split()) for d in docs)} words) -> {n_chunks} chunks, "
            f"{statistics.mean(ingest_s):.3f} s a document (max {max(ingest_s):.3f}); "
            f"GET /documents lists the 16 on {smi}")

        # 3. /search: the first hit is the query's document; the top 4 on the
        # card against the port's runtime on the CPU in f32 (same store, loaded
        # from its persisted files, and the same BM25 index)
        picks = [int(k) for k in rng.choice(RAG_DOCS, RAG_QUERIES, replace=False)]
        searches, search_ms = [], []
        for k in picks:
            query = docs[k][0]
            t1 = time.perf_counter()
            status, text = _http(base, "POST", "/search", {"query": query, "top_k": 4})
            search_ms.append((time.perf_counter() - t1) * 1e3)
            chunks = json.loads(text)["chunks"] if status == 200 else None
            if not chunks or chunks[0]["filename"] != names[k]:
                raise AssertionError(f"/search for a sentence of {names[k]}: {status} {text[:300]}")
            searches.append((k, query, chunks))
        cpu_emb = TorchEmbedder(model_name=EMBED_MODEL, device="cpu", params=_cpu_f32(emb._params),
                                dtype=torch.float32, batching=BatchingConfig(enable="off"))
        cpu_rr = TorchReranker(model_name=RERANK_MODEL, device="cpu", params=_cpu_f32(rr._params),
                               head={k: v.to("cpu", torch.float32) for k, v in rr._head.items()},
                               dtype=torch.float32, batching=BatchingConfig(enable="off"))
        cpu_logits = {}  # (query, passages) -> the CPU's logits, kept for the tie check
        cpu_score = cpu_rr.score

        def kept_score(query, passages):
            key = (query, tuple(passages))
            if key not in cpu_logits:
                cpu_logits[key] = cpu_score(query, passages)
            return cpu_logits[key]

        cpu_rr.score = kept_score
        cpu_store = TorchVectorStore(emb.dimensions, persist_dir=config.vector_store.persist_dir,
                                     device="cpu")
        card_store = runtime._STORES["default"]
        cpu_keys = (emb_key[:3] + ("cpu",), rr_key[:3] + ("cpu",))
        emb_mod._EMBEDDER_CACHE[cpu_keys[0]], rr_mod._RERANKER_CACHE[cpu_keys[1]] = cpu_emb, cpu_rr
        try:
            runtime._STORES["default"] = cpu_store
            runtime.set_device("cpu")
            wants = [orig_retrieve(query, top_k=4) for _, query, _ in searches]
            # the reranker's logits on the card against the CPU's, pair by pair
            logit_err = max((float(np.abs(rr.score(q, list(passages)) - want).max())
                             for (q, passages), want in cpu_logits.items()), default=0.0)
        finally:
            runtime._STORES["default"] = card_store
            runtime.set_device(None)
            emb_mod._EMBEDDER_CACHE.pop(cpu_keys[0])
            rr_mod._RERANKER_CACHE.pop(cpu_keys[1])
            cpu_emb.close()
            cpu_rr.close()
        if logit_err > LOGIT_ABS:
            raise AssertionError(f"rerank logits on the card differ from the CPU's f32 by "
                                 f"{logit_err:.4g} (limit {LOGIT_ABS})")
        # where the orders differ, the card's must still follow the CPU's
        # logits up to twice the largest card-vs-CPU difference: each pair in
        # the card's order, and each candidate it cut against its last one
        tie_tol, ties = 2 * logit_err, 0
        for (k, query, chunks), want in zip(searches, wants):
            got = [c["content"] for c in chunks]
            if got == [h.chunk.text for h in want] and \
                    [c["filename"] for c in chunks] == [h.chunk.source for h in want]:
                continue
            scored = [(p, v) for (q, p), v in cpu_logits.items() if q == query]
            if not scored:  # no rerank ran: nothing may differ
                raise AssertionError(f"/search top 4 on the card for {names[k]} != CPU f32")
            cpu = dict(zip(*scored[0]))
            if any(t not in cpu for t in got) or any(
                    cpu[got[i]] < cpu[got[j]] - tie_tol
                    for i in range(len(got)) for j in range(i + 1, len(got))) or any(
                    v > cpu[got[-1]] + tie_tol for t, v in cpu.items() if t not in got):
                raise AssertionError(f"/search top 4 on the card for {names[k]} breaks the CPU's "
                                     f"rerank order beyond {tie_tol:.4g}")
            ties += 1
        note(f"POST /search x{RAG_QUERIES} (a sentence of each document, top_k 4): the first hit "
            f"is that document every time; the top 4 chunks equal the port's runtime on the CPU "
            f"in f32 ({ties} differ only inside a rerank near-tie of {tie_tol:.4g}: the card's "
            f"rerank logits are within {logit_err:.4g} of the CPU's, limit {LOGIT_ABS}); "
            f"{statistics.median(search_ms):.1f} ms p50, {max(search_ms):.1f} ms max on {smi}")

        # 4. concurrent /generate: 8 over the knowledge base and one without
        warm = _generate_stream(base, docs[picks[0]][2], True, max_tokens=8)
        if warm[0][-1]["choices"][0]["finish_reason"] != "[DONE]":
            raise AssertionError("the warm-up /generate did not end in [DONE]")

        def round_of(sentence_idx, profiled=False):
            results, errors = {}, []

            def call(name, query, kb):
                try:
                    results[name] = (query, kb) + _generate_stream(base, query, kb)
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(f"{name}: {exc!r}")

            calls = [(f"kb{i}", docs[k][sentence_idx], True) for i, k in enumerate(picks)]
            calls.append(("plain", "Say something about a graphics card.", False))
            threads = [threading.Thread(target=call, args=c, name=f"smoke-rag-{c[0]}", daemon=True)
                       for c in calls]
            t1 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(600)
            wall = time.perf_counter() - t1
            if errors or len(results) != len(calls):
                raise AssertionError(f"/generate round: {errors}")
            return results, wall

        recorder.prompts.clear()
        retrieved.clear()
        reset_counts()
        before = engine.stats()
        with SyncCounter() as syncs:
            results, wall = round_of(1)
        launched = counts()
        after = engine.stats()
        bad = {developer_rag.NO_CONTEXT_MSG, developer_rag.NO_DOCS_MSG}
        ttft, retr_ms, prompt_ids, n_tokens = [], [], [], 0
        for name, (query, kb, frames, first, total) in results.items():
            if not frames or frames[-1]["choices"][0]["finish_reason"] != "[DONE]":
                raise AssertionError(f"/generate {name} does not end in [DONE]")
            answer = "".join(f["choices"][0]["message"]["content"] for f in frames[:-1]
                             if f.get("choices"))
            if answer.strip() in bad:
                raise AssertionError(f"/generate {name} answered {answer!r}")
            ttft.append(first)
            if not kb:
                continue
            hits, ms = retrieved[query]
            retr_ms.append(ms)
            top = hits[0].chunk.text
            mine = [p for p in recorder.prompts if query in engine.tokenizer.decode(p)]
            if len(mine) != 1 or top not in engine.tokenizer.decode(mine[0]):
                raise AssertionError(f"/generate {name}: the engine's prompt lacks the top hit")
            prompt_ids.append(len(mine[0]))
        if len(recorder.prompts) != len(results):
            raise AssertionError(f"{len(recorder.prompts)} prompts reached the engine for "
                                 f"{len(results)} requests")
        missing = [n for n in RAG_EXPECTED if launched[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched under /generate: {missing}")
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while retrieval ran on request threads")
        d_rows = after["decode_rows"] - before.get("decode_rows", 0)
        d_time = after["decode_time_s"] - before.get("decode_time_s", 0.0)
        out.update({
            "ingest_s_per_doc": statistics.mean(ingest_s), "ingest_s_max": max(ingest_s),
            "chunks": n_chunks, "search_ms_p50": statistics.median(search_ms),
            "search_ms_max": max(search_ms), "search_rerank_ties": ties,
            "rerank_logit_max_abs": logit_err,
            "ttft_s_mean": statistics.mean(ttft), "ttft_s_max": max(ttft),
            "retrieve_ms_mean": statistics.mean(retr_ms), "retrieve_ms_max": max(retr_ms),
            "prompt_ids_min": min(prompt_ids), "prompt_ids_max": max(prompt_ids),
            "decode_tokens_per_s": d_rows / d_time if d_time else None,
            "round_s": wall, "launches": launched, "dispatch_syncs": dispatch_syncs,
            "syncs_by_thread": dict(syncs.counts), "prefix_cache": _prefix_counts(before, after),
        })
        note(f"prefix cache (JAX default, auto) over the round: {out['prefix_cache']['hits']} hits, "
             f"{out['prefix_cache']['misses']} misses")
        note(f"/generate x{len(results)} concurrent (8 over the knowledge base, 1 without; "
            f"max_tokens 64): every stream ends in [DONE], none is a no-context answer, each "
            f"engine prompt holds its top hit's text; prompts {min(prompt_ids)}-"
            f"{max(prompt_ids)} ids (prefill_chunk {ec.prefill_chunk}); TTFT (sent -> first "
            f"answer frame) mean {out['ttft_s_mean']:.3f} s, max {out['ttft_s_max']:.3f} s, of "
            f"which retrieval (runtime.retrieve) mean {out['retrieve_ms_mean']:.1f} ms, max "
            f"{out['retrieve_ms_max']:.1f} ms; decode {out['decode_tokens_per_s'] or 0:.1f} "
            f"tokens/s (engine decode wall time), round {wall:.2f} s on {smi}")
        note(f"launches under /generate: {launched}; synchronizing calls by thread: "
            f"{dict(syncs.counts) or 'none'} (LLM dispatch thread: {dispatch_syncs})")

        # the device's idle share over a second round, traced
        from torch.profiler import ProfilerActivity, profile

        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as exc:  # noqa: BLE001 - a measurement, reported as not measured
            prof, why = None, exc
        try:
            _, wall2 = round_of(2)
            torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        out["idle_share"] = None
        if prof is not None:
            try:
                kernels = _device_spans(prof)
                busy = _busy_ms(kernels)
                out["idle_share"] = max(0.0, 1.0 - busy / (wall2 * 1e3))
                out["device_busy_ms"], out["traced_round_s"] = busy, wall2
                note(f"device over a second traced round ({len(kernels)} device events): busy "
                    f"{busy:.0f} ms of {wall2 * 1e3:.0f} ms, idle share {out['idle_share']:.1%} "
                    f"on {smi}")
            except Exception as exc:  # noqa: BLE001 - as above
                why = exc
        if out["idle_share"] is None:
            note(f"device idle share over /generate: not measured ({why!r})")

        # 5. delete one document from the store and BM25
        k0, q0 = searches[0][0], searches[0][1]
        n_bm25 = runtime.get_bm25_index("default").count()
        status, text = _http(base, "DELETE", f"/documents?filename={names[k0]}")
        if status != 200:
            raise AssertionError(f"DELETE /documents: {status} {text}")
        listed = json.loads(_http(base, "GET", "/documents")[1])["documents"]
        status, text = _http(base, "POST", "/search", {"query": q0, "top_k": 4})
        left = [c["filename"] for c in json.loads(text)["chunks"]]
        gone = n_bm25 - runtime.get_bm25_index("default").count()
        if names[k0] in listed or names[k0] in left or gone <= 0 or \
                runtime.get_vector_store("default").count() != n_chunks - gone:
            raise AssertionError(f"{names[k0]} is still served after DELETE: {listed}, {left}")
        note(f"DELETE /documents?filename={names[k0]}: {gone} chunks left the store and BM25; "
            f"its sentence now finds {left or 'nothing'}")

        # 6. a spent deadline
        status, text = _http(base, "POST", "/generate", {
            "messages": [{"role": "user", "content": docs[picks[1]][3]}],
            "use_knowledge_base": True, "deadline_ms": 1})
        if status != 504:
            raise AssertionError(f"/generate with deadline_ms 1: {status} {text[:200]}")
        note(f"/generate with deadline_ms 1: 504 {json.loads(text)['detail']!r}")
    finally:
        runtime.retrieve = orig_retrieve
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(60)
        if not keep or sys.exc_info()[0] is not None:
            _rag_teardown(dep)
    log(f"phase rag: ok ({time.time() - t0:.1f} s)")
    dep["corpus"] = (docs, files)
    return out, (dep if keep else None)


# --------------------------------------------------------------------- #
# Phase 8: the text chains

CHAIN_SEED = 20241  # every phase 8 engine request samples from this seed
CHAIN_CONVERSATIONS, CHAIN_TURNS = 4, 3


def _answer(frames) -> str:
    return "".join(f["choices"][0]["message"]["content"] for f in frames
                   if f.get("choices") and f["choices"][0].get("message"))


def _check_answer(what, frames, bad=()) -> str:
    """The answer of a streamed /generate: it ends in [DONE], has no
    warnings frame (a DegradedWarning) and is none of ``bad``. It may be
    empty: random weights may sample a stop token first."""
    if not frames or frames[-1]["choices"][0]["finish_reason"] != "[DONE]":
        raise AssertionError(f"{what}: the stream does not end in [DONE]")
    warned = [f["warnings"] for f in frames if f.get("warnings")]
    if warned:
        raise AssertionError(f"{what}: warnings {warned}")
    answer = _answer(frames)
    if answer.strip() in bad:
        raise AssertionError(f"{what}: answered {answer!r}")
    return answer


def _concurrently(calls) -> dict:
    """Run ``calls`` ({name: fn}) on threads of their own; their results by
    name, or the first error raised."""
    results, errors = {}, []

    def run(name, fn):
        try:
            results[name] = fn()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{name}: {exc!r}")

    threads = [threading.Thread(target=run, args=(name, fn), name=f"smoke-{name}", daemon=True)
               for name, fn in calls.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    if errors or len(results) != len(calls):
        raise AssertionError(f"concurrent requests failed: {errors or 'timed out'}")
    return results


def phase_chains(dev, smi, seed=0, dep=None, encoders=None) -> dict:
    """The text chains through the port's chain server on the card (module
    docstring, phase 8): ``dep`` is phase 7's deployment, still up, or None
    to build one (with phase 6's ``encoders`` when given) and ingest phase
    7's corpus into ``default``."""
    import os
    import tempfile

    import numpy as np

    from generativeaiexamples_tpu_torch import config as config_mod
    from generativeaiexamples_tpu_torch.chains import developer_rag, multi_turn, registry, runtime
    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.engine import server as engine_server
    from generativeaiexamples_tpu_torch.server.api import make_server

    t0 = time.time()

    def note(msg):
        log(f"  [{time.time() - t0:.1f} s] {msg}")

    if dep is None:
        dep = _rag_deploy(encoders)
        try:
            docs = _rag_corpus(np.random.RandomState(seed + 7))
            files = _rag_files(docs)
            src = tempfile.mkdtemp(dir=dep["tmp"])
            for name, data in files:
                path = os.path.join(src, name)
                with open(path, "wb") as fh:
                    fh.write(data)
                runtime.ingest_file(path, name)
        except BaseException:
            _rag_teardown(dep)
            raise
        note(f"engine A through create_llm ({dep['engine_s']:.1f} s) and {EMBED_MODEL}/"
             f"{RERANK_MODEL} {'from phase 6' if encoders is not None else 'by the factories'}; "
             f"phase 7's {len(files)} documents ingested into 'default'")
    else:
        docs, files = dep["corpus"]
        note(f"phase 7's engine A, encoders and 'default' collection "
             f"({runtime.get_vector_store('default').count()} chunks)")
    config, engine = dep["config"], dep["engine"]
    stats0 = engine.stats()
    names = [n for n, _ in files]
    # the documents 'default' still holds (phase 7 deletes one)
    present = set(runtime.get_vector_store("default").sources())
    avail = [k for k in range(RAG_DOCS) if names[k] in present]
    bad = {developer_rag.NO_CONTEXT_MSG, developer_rag.NO_DOCS_MSG}
    recorder = _RecordingEngine(engine, seed=CHAIN_SEED)
    llm_key = (config.llm.model_engine, config.llm.server_url, config.llm.model_name)
    llm_backend._LLM_CACHE[llm_key] = llm_backend.TorchLLMBackend(engine=recorder)
    servers, out, ttft, prompt_ids = [], {}, collections.defaultdict(list), {}

    def serve(example):
        """A chain server for ``example`` (resolved through the registry)."""
        server = make_server("127.0.0.1", 0, registry.resolve_example(example))
        thread = threading.Thread(target=server.serve_forever, name=f"smoke-{example}-server",
                                  daemon=True)
        thread.start()
        servers.append((server, thread))
        return f"http://127.0.0.1:{server.server_address[1]}"

    def prompts_with(text):
        with recorder._lock:
            return [p for p in recorder.prompts if text in engine.tokenizer.decode(p)]

    def ids_line(chain):
        return f"{min(prompt_ids[chain])}-{max(prompt_ids[chain])}"

    t_phase = time.perf_counter()
    reset_counts()
    try:
        with SyncCounter() as syncs:
            # 1. simple_rag: its own collection, 2000-character chunks
            base = serve("simple_rag")
            for name, data in files:
                raw, ctype = _multipart(name, data)
                status, text = _http(base, "POST", "/documents", raw=raw, ctype=ctype)
                if status != 200 or json.loads(text) != {"message": "File uploaded successfully"}:
                    raise AssertionError(f"simple_rag POST /documents {name}: {status} {text}")
            status, text = _http(base, "GET", "/documents")
            if status != 200 or sorted(json.loads(text)["documents"]) != sorted(names):
                raise AssertionError(f"simple_rag GET /documents: {status} {text[:300]}")
            n_sr = runtime.get_vector_store("simple_rag").count()
            if runtime.get_bm25_index("simple_rag").count() != n_sr:
                raise AssertionError("simple_rag: the store and BM25 hold different chunk counts")
            for k in (0, 5, 10, RAG_DOCS - 1):
                status, text = _http(base, "POST", "/search", {"query": docs[k][0], "top_k": 4})
                chunks = json.loads(text)["chunks"] if status == 200 else None
                if not chunks or chunks[0]["filename"] != names[k]:
                    raise AssertionError(f"simple_rag /search for a sentence of {names[k]}: "
                                         f"{status} {text[:300]}")
            # four concurrent questions, each of sentences from four documents
            questions = {f"sr{i}": " ".join(docs[(4 * i + j) % RAG_DOCS][1] for j in range(4))
                         for i in range(4)}
            results = _concurrently({n: (lambda q=q: _generate_stream(base, q, True))
                                     for n, q in questions.items()})
            prompt_ids["simple_rag"] = []
            for n, (frames, first, _) in results.items():
                _check_answer(f"simple_rag {n}", frames, bad)
                ttft["simple_rag"].append(first)
                mine = prompts_with(questions[n])
                if len(mine) != 1:
                    raise AssertionError(f"simple_rag {n}: {len(mine)} engine prompts")
                if len(mine[0]) >= engine.max_seq_len:
                    raise AssertionError(f"simple_rag {n}: a prompt of {len(mine[0])} ids")
                prompt_ids["simple_rag"].append(len(mine[0]))
            note(f"simple_rag: {len(files)} documents over POST /documents -> {n_sr} chunks of "
                 f"<= 2000 characters in 'simple_rag' (store and BM25); /search finds each "
                 f"query's document first; 4 concurrent /generate (4 documents' sentences each, "
                 f"max_tokens 64) answer 200 with no warning; prompts {ids_line('simple_rag')} "
                 f"ids; TTFT mean {statistics.mean(ttft['simple_rag']):.3f} s, max "
                 f"{max(ttft['simple_rag']):.3f} s on {smi}")

            # 2. multi_turn: 4 conversations x 3 turns, memory in conv_store
            base = serve("multi_turn")
            with recorder._lock:
                recorder.prompts.clear()
            convo_docs = [avail[i] for i in (1, 5, 9, 13)]

            def conversation(c):
                history, turns = [], []
                for t in range(CHAIN_TURNS):
                    query = docs[convo_docs[c]][t]
                    frames, first, _ = _generate_stream(base, query, True, history=history)
                    answer = _check_answer(f"multi_turn conversation {c} turn {t}", frames, bad)
                    turns.append((query, first))
                    history += [("user", query), ("assistant", answer)]
                return turns

            results = _concurrently({f"mt{c}": (lambda c=c: conversation(c))
                                     for c in range(CHAIN_CONVERSATIONS)})
            want = 2 * CHAIN_CONVERSATIONS * CHAIN_TURNS
            n_dense = runtime.get_vector_store(multi_turn.CONV_COLLECTION).count()
            n_bm25 = runtime.get_bm25_index(multi_turn.CONV_COLLECTION).count()
            if n_dense != want or n_bm25 != want:
                raise AssertionError(f"conv_store holds {n_dense} chunks (BM25 {n_bm25}), "
                                     f"not {want}")
            prompt_ids["multi_turn"], recalled = [], 0
            for c, turns in enumerate(results[f"mt{c}"] for c in range(CHAIN_CONVERSATIONS)):
                first_q = turns[0][0]
                hits = runtime.retrieve(first_q, collection=multi_turn.CONV_COLLECTION)
                if f"User previously responded with {first_q}" not in [h.chunk.text for h in hits]:
                    raise AssertionError(f"conversation {c}: a conv_store retrieve of its first "
                                         f"question misses its memory")
                for t, (query, first) in enumerate(turns):
                    ttft["multi_turn"].append(first)
                    mine = prompts_with("User Query: " + query)
                    if len(mine) != 1:
                        raise AssertionError(f"multi_turn {c}/{t}: {len(mine)} engine prompts")
                    prompt_ids["multi_turn"].append(len(mine[0]))
                    recalled += t > 0 and "User previously responded with" in \
                        engine.tokenizer.decode(mine[0])
            note(f"multi_turn: {CHAIN_CONVERSATIONS} concurrent conversations x {CHAIN_TURNS} "
                 f"turns (history in messages) answer 200 with no warning; conv_store holds "
                 f"{n_dense} chunks in the store and BM25; each first question retrieves its "
                 f"'User previously responded with ...' memory; {recalled} of "
                 f"{CHAIN_CONVERSATIONS * (CHAIN_TURNS - 1)} later turns' prompts held a memory; "
                 f"prompts {ids_line('multi_turn')} ids; TTFT mean "
                 f"{statistics.mean(ttft['multi_turn']):.3f} s, max "
                 f"{max(ttft['multi_turn']):.3f} s on {smi}")

            # 3. query_decomposition: 2 concurrent answers, >= 3 engine requests each
            base = serve("query_decomposition")
            questions = {f"qd{i}": docs[avail[j]][2] for i, j in enumerate((3, 7))}
            with recorder._lock:
                recorder.prompts.clear()
            before = engine.stats()["requests_prefilled"]
            results = _concurrently({n: (lambda q=q: _generate_stream(base, q, True))
                                     for n, q in questions.items()})
            per_answer = (engine.stats()["requests_prefilled"] - before) / len(questions)
            prompt_ids["query_decomposition"], qd_requests = [], []
            for n, (frames, first, _) in results.items():
                _check_answer(f"query_decomposition {n}", frames, bad)
                ttft["query_decomposition"].append(first)
                # the decomposition, extract and final prompts quote the question
                mine = prompts_with("Question:\n" + questions[n]) + \
                    prompts_with("Question: " + questions[n])
                qd_requests.append(len(mine))
                prompt_ids["query_decomposition"] += [len(p) for p in mine]
            if per_answer < 3 or min(qd_requests) < 3:
                raise AssertionError(f"query_decomposition: {per_answer} engine requests an "
                                     f"answer ({qd_requests} prompts hold each question)")
            note(f"query_decomposition: 2 concurrent /generate answer 200 with no warning; "
                 f"{per_answer:.1f} engine requests an answer (engine stats; prompts holding "
                 f"each question: {qd_requests}: decomposition, extract, final); prompts "
                 f"{ids_line('query_decomposition')} ids; TTFT mean "
                 f"{statistics.mean(ttft['query_decomposition']):.3f} s, max "
                 f"{max(ttft['query_decomposition']):.3f} s on {smi}")

            # 4. api_catalog in process, then through the engine server
            query = docs[avail[11]][1]
            legs = {}
            eng_server = engine_server.make_server("127.0.0.1", 0, engine=recorder)
            eng_thread = threading.Thread(target=eng_server.serve_forever,
                                          name="smoke-engine-server", daemon=True)
            eng_thread.start()
            servers.append((eng_server, eng_thread))
            remote_env = dict(REMOTE_LLM_ENV, APP_LLM_SERVERURL=(
                f"http://127.0.0.1:{eng_server.server_address[1]}"))
            for leg in ("in-process", "remote"):
                if leg == "remote":  # _rag_teardown restores the environment
                    os.environ.update(remote_env)
                    config_mod.get_config.cache_clear()
                with recorder._lock:
                    recorder.prompts.clear()
                base = serve("api_catalog")
                frames, first, _ = _generate_stream(base, query, True)
                legs[leg] = (_check_answer(f"api_catalog {leg}", frames, bad),
                             [list(p) for p in recorder.prompts])
                ttft["api_catalog"].append(first)
                if len(legs[leg][1]) != 1:
                    raise AssertionError(f"api_catalog {leg}: {len(legs[leg][1])} engine prompts")
            backend = runtime.get_llm()
            if type(backend).__name__ != "RemoteLLMBackend":
                raise AssertionError(f"api_catalog's remote leg answered through "
                                     f"{type(backend).__name__}")
            if legs["remote"][1] != legs["in-process"][1]:
                raise AssertionError("api_catalog: the engine got other prompt ids through the "
                                     "engine server than through the in-process backend")
            if legs["remote"][0] != legs["in-process"][0]:
                raise AssertionError(f"api_catalog: the remote stream {legs['remote'][0]!r} "
                                     f"differs from the in-process one {legs['in-process'][0]!r}")
            prompt_ids["api_catalog"] = [len(legs["remote"][1][0])]
            note(f"api_catalog: one /generate in process, then the same through "
                 f"RemoteLLMBackend -> the engine server -> engine A: the same "
                 f"{prompt_ids['api_catalog'][0]} prompt ids and the same "
                 f"{len(legs['remote'][0])}-character answer (seed {CHAIN_SEED}); TTFT "
                 f"{ttft['api_catalog'][0]:.3f} s in process, {ttft['api_catalog'][1]:.3f} s "
                 f"remote on {smi}")
        launched = counts()
        wall = time.perf_counter() - t_phase
        missing = [n for n in RAG_EXPECTED if launched[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched by the chains: {missing}")
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        if dispatch_syncs:
            raise AssertionError(f"the LLM dispatch thread waited for the card {dispatch_syncs} "
                                 f"times while the chains ran")
        out.update({
            "ttft_s": {c: {"mean": statistics.mean(v), "max": max(v)} for c, v in ttft.items()},
            "prompt_ids": {c: [min(v), max(v)] for c, v in prompt_ids.items()},
            "qd_engine_requests_per_answer": per_answer, "simple_rag_chunks": n_sr,
            "conv_store_chunks": n_dense, "launches": launched, "dispatch_syncs": dispatch_syncs,
            "syncs_by_thread": dict(syncs.counts), "wall_s": wall,
            "prefix_cache": _prefix_counts(stats0, engine.stats()),
        })
        note(f"prefix cache (JAX default, auto) over the phase: {out['prefix_cache']['hits']} "
             f"hits, {out['prefix_cache']['misses']} misses")
        note(f"launches in the phase: " + ", ".join(f"{n} {launched[n]}" for n in RAG_EXPECTED)
             + f"; synchronizing calls by thread: {dict(syncs.counts) or 'none'} (LLM dispatch "
             f"thread: {dispatch_syncs}); phase wall {wall:.1f} s on {smi}")
    finally:
        for server, thread in servers:
            server.shutdown()
            server.server_close()
            thread.join(60)
        _rag_teardown(dep)
    log(f"phase chains: ok ({time.time() - t0:.1f} s)")
    return out


# --------------------------------------------------------------------- #
# Phase 9: the automatic prefix KV cache

# the JAX bench's shared-prefix pass (bench.py): one preamble of
# PREFIX_CHUNKS prefill chunks, PREFIX_QUESTIONS distinct questions of
# PREFIX_QUESTION_IDS ids after it, PREFIX_TOKENS greedy tokens each, one
# request at a time
PREFIX_CHUNKS, PREFIX_QUESTIONS, PREFIX_QUESTION_IDS, PREFIX_TOKENS = 4, 16, 128, 16
PREFIX_RECIPES = "AD"  # the bf16 paged pool (shared pages) and the int8 fixed store (copies)


def _prefix_stream(engine, prompt, params):
    """One request alone: (stream, TTFT s, prefill chunks it dispatched)."""
    c0 = engine.stats()["prefill_chunks"]
    t0 = time.perf_counter()
    q = engine.generate_ids(prompt, params)
    first = q.get(timeout=600)
    ttft = time.perf_counter() - t0
    stream = [] if first is None else [first] + _drain_ids(q)
    return stream, ttft, engine.stats()["prefill_chunks"] - c0


def _settle(engine, timeout=60.0) -> None:
    """Wait until the dispatch thread has released every slot."""
    deadline = time.time() + timeout
    while engine._slot_req and time.time() < deadline:
        time.sleep(0.01)
    if engine._slot_req:
        raise AssertionError("slots still held after every stream ended")


def _last_logits(engine, ids):
    """The logits after ``ids``, prefilled chunk by chunk through the model
    functions over a page pool of their own (the margin of a cold
    reference's token)."""
    from generativeaiexamples_tpu_torch.models import llama

    cfg, dev, ec = engine.model_config, engine.device, engine.engine_config
    C, page = ec.prefill_chunk, ec.page_size
    n_chunks = -(-len(ids) // C)
    pmax = engine._attention_window(n_chunks * C) // page
    pool = llama.init_kv_pool(cfg, 1 + pmax, page, torch.bfloat16, dev, quantized=engine._kv_quant)
    tables = torch.arange(1, 1 + pmax, dtype=torch.int32, device=dev)[None]
    for k in range(n_chunks):
        seg = ids[k * C:(k + 1) * C]
        h, _ = llama.extend_layers_paged(
            engine.params, cfg, torch.tensor([seg + [0] * (C - len(seg))], device=dev),
            torch.tensor([k * C], device=dev), torch.tensor([len(seg)], device=dev),
            torch.tensor([0], device=dev), tables, pool,
            engine._attention_window(min((k + 1) * C, engine.max_seq_len)), page,
            quant_kernel=engine._quant_kernel)
    return llama._head(engine.params, h[:, None, :], cfg, engine._quant_kernel)[0, 0, : engine._sample_vocab]


def _tie_checked(engine, label, prompt, got, want) -> int:
    """``got`` equals its cold reference ``want``, or the two part at a
    token whose top-1 margin in the reference's logits is within
    LOGITS_TOL (a random-init tie; after it the contexts differ). Returns
    1 for a tie, 0 for equal streams."""
    if got == want:
        return 0
    at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
    top2 = torch.topk(_last_logits(engine, prompt + want[:at]).float(), 2).values
    margin = float(top2[0] - top2[1])
    log(f"    {label}: parts from its cold reference at token {at} (got "
        f"{got[at] if at < len(got) else 'the end'}, cold {want[at] if at < len(want) else 'the end'}), "
        f"where the cold top-1 margin is {margin:.4g} (tolerance {LOGITS_TOL})")
    if margin > LOGITS_TOL:
        raise AssertionError(f"{label}: the warm engine's stream differs from the cold one "
                             f"beyond a tie (margin {margin:.4g} > {LOGITS_TOL})")
    return 1


def prefix_recipe(dev, smi, name, quantization, kv_dtype, layout, expected, seed) -> dict:
    """One recipe's shared-prefix pass: a cache-off engine gives the cold
    streams, then an engine at the JAX default (``prefix_cache_enable``
    auto, 4 slots) on the same weights gives the warm ones; the two are
    built one after the other."""
    import random

    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams

    rng = random.Random(seed * 1000 + ord(name))
    base = EngineConfig(model_config_name=MODEL, quantization=quantization,
                        kv_cache_dtype=kv_dtype, kv_layout=layout)
    C = base.prefill_chunk
    preamble = [256] + [rng.randrange(1, 256) for _ in range(PREFIX_CHUNKS * C - 1)]
    prompts = [preamble + [rng.randrange(1, 256) for _ in range(PREFIX_QUESTION_IDS)]
               for _ in range(PREFIX_QUESTIONS)]
    # the mixed wave: a warm row (the preamble and a new question), a cold
    # 1.5k-id row and a 300-id row (one chunk: the flash kernel)
    wave = [preamble + [rng.randrange(1, 256) for _ in range(PREFIX_QUESTION_IDS)],
            [256] + [rng.randrange(1, 256) for _ in range(1499)],
            [256] + [rng.randrange(1, 256) for _ in range(299)]]
    params = SamplingParams(temperature=0.0, max_tokens=PREFIX_TOKENS)
    out = {"prompt_ids": len(prompts[0]), "preamble_ids": len(preamble)}

    t0 = time.time()
    cold = LLMEngine(dataclasses.replace(base, prefix_cache_enable="off"), device=dev)
    weights = cold.params
    try:
        if cold._prefix is not None or cold._paged != (layout == "paged"):
            raise AssertionError(f"{name}: the cache-off engine is not the one asked for")
        cold_runs = [_prefix_stream(cold, p, params) for p in prompts]
        wave_refs = [_prefix_stream(cold, p, params)[0] for p in wave]
    finally:
        cold.shutdown()
        del cold
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  {name}: cold engine (prefix_cache_enable off) served {PREFIX_QUESTIONS} requests "
        f"of {out['prompt_ids']} ids ({time.time() - t0:.1f} s with its build)")

    t1 = time.time()
    warm = LLMEngine(base, device=dev, params=weights)
    try:
        if warm._prefix is None or warm._paged != (layout == "paged"):
            raise AssertionError(f"{name}: the JAX default built no prefix cache")
        cache_bytes = warm.prefix_cache_bytes()
        if warm._paged:
            mem = (f"pool {warm._pool_pages} pages x {base.page_size} "
                   f"({sum(t.numel() * t.element_size() for c in warm._cache for t in c.values()) / 2**30:.2f} GiB), "
                   f"{cache_bytes / 2**30:.2f} GiB of it the {base.prefix_cache_slots} entries' strips")
        else:
            mem = (f"store {base.prefix_cache_slots} slots x {warm.max_seq_len} rows "
                   f"{kv_dtype} ({cache_bytes / 2**30:.2f} GiB)")
        log(f"  {name}: warm engine (prefix_cache_enable auto, {base.prefix_cache_slots} slots): {mem}")
        reset_counts()
        snap = None
        with SyncCounter() as syncs:
            warm_runs = [_prefix_stream(warm, prompts[0], params)]
            if warm._paged:  # the donor's pages, right after its insert
                (entry,) = warm._prefix._entries
                snap = (list(entry.pages),
                        [{k: t[entry.pages].clone() for k, t in c.items()} for c in warm._cache])
            warm_runs += [_prefix_stream(warm, p, params) for p in prompts[1:]]
            _settle(warm)
            st = warm.stats()
            with warm.hold_admissions():
                reqs = [warm.submit(p, params) for p in wave]
            wave_out = [_drain_ids(r.out_queue) for r in reqs]
            _settle(warm)
        launched = counts()
        dispatch_syncs = syncs.counts["torch-llm-engine"]
        end = warm.stats()

        # identity, hits and chunks
        mismatched = [i for i, ((a, _, _), (b, _, _)) in enumerate(zip(warm_runs, cold_runs)) if a != b]
        if mismatched:
            raise AssertionError(f"{name}: warm streams {mismatched} differ from their cold streams")
        cold_chunks = [c for _, _, c in cold_runs]
        warm_chunks = [c for _, _, c in warm_runs]
        n_chunks = -(-out["prompt_ids"] // C)
        hits, misses = st["prefix_cache_hits"], st["prefix_cache_misses"]
        if cold_chunks != [n_chunks] * PREFIX_QUESTIONS or \
                warm_chunks != [n_chunks] + [1] * (PREFIX_QUESTIONS - 1):
            raise AssertionError(f"{name}: prefill chunks cold {cold_chunks}, warm {warm_chunks}")
        if (hits, misses) != (PREFIX_QUESTIONS - 1, 1) or \
                st["prefix_cache_tokens_reused"] != (PREFIX_QUESTIONS - 1) * len(preamble):
            raise AssertionError(f"{name}: hits {hits}, misses {misses}, tokens reused "
                                 f"{st['prefix_cache_tokens_reused']}")
        pages_per_hit = len(preamble) // base.page_size
        want = ((0, (PREFIX_QUESTIONS - 1) * pages_per_hit) if warm._paged
                else (PREFIX_QUESTIONS, 0))  # fixed: 1 insert + 15 fetches
        if (st["prefix_copy_dispatches"], st["prefix_pages_mapped"]) != want:
            raise AssertionError(f"{name}: copies {st['prefix_copy_dispatches']}, pages mapped "
                                 f"{st['prefix_pages_mapped']}, expected {want}")
        if dispatch_syncs:
            raise AssertionError(f"{name}: the dispatch thread waited for the card {dispatch_syncs} times")
        missing = [n for n in expected if launched[n] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched by the prefix path: {missing}")
        if snap is not None:
            pages, before = snap
            changed = [(i, k) for i, (b, c) in enumerate(zip(before, warm._cache))
                       for k in b if not torch.equal(b[k], c[k][pages])]
            if changed:
                raise AssertionError(f"{name}: donated pages changed under decode: {changed[:4]}")
            held = len({p for e in warm._prefix._entries for p in e.pages or ()})
            if end["pages_in_use"] != held:
                raise AssertionError(f"{name}: {end['pages_in_use']} pages in use, entries hold {held}")
        ties = sum(_tie_checked(warm, f"{name} mixed wave {label}", p, got, ref)
                   for label, p, got, ref in zip(("warm", "cold 1.5k", "300-id"), wave, wave_out,
                                                 wave_refs))
        if end["prefix_cache_hits"] - hits != 1:
            raise AssertionError(f"{name}: the mixed wave's warm row did not hit")
    finally:
        warm.shutdown()
        del warm
        gc.collect()
        torch.cuda.empty_cache()

    cold_ttft = [t for _, t, _ in cold_runs]
    warm_ttft = [t for _, t, _ in warm_runs[1:]]
    out.update({
        "ttft_cold_s": {"p50": statistics.median(cold_ttft), "max": max(cold_ttft)},
        "ttft_warm_s": {"p50": statistics.median(warm_ttft), "max": max(warm_ttft)},
        "ttft_first_warm_engine_s": warm_runs[0][1],
        "warm_over_cold_p50": statistics.median(warm_ttft) / statistics.median(cold_ttft),
        "chunks_cold": n_chunks, "chunks_warm": 1, "hits": hits, "misses": misses,
        "tokens_reused": st["prefix_cache_tokens_reused"],
        "copy_dispatches": st["prefix_copy_dispatches"], "pages_mapped": st["prefix_pages_mapped"],
        "cache_bytes": cache_bytes, "dispatch_syncs": dispatch_syncs,
        "mixed_wave_ties": ties, "launches": launched,
        "syncs_by_thread": dict(syncs.counts), "wall_s": time.time() - t0,
    })
    log(f"  {name}: {PREFIX_QUESTIONS} warm streams token-identical to the cold ones; prefill "
        f"chunks a request cold {n_chunks}, warm 1; hits {hits}, misses {misses}, tokens reused "
        f"{out['tokens_reused']}; store copies {out['copy_dispatches']}, pages mapped "
        f"{out['pages_mapped']}; dispatch-thread syncs {dispatch_syncs}"
        + ("; donated pages bitwise unchanged, pages in use = the entries' pages" if snap else ""))
    log(f"  {name}: TTFT cold p50 {out['ttft_cold_s']['p50']:.4f} s max {out['ttft_cold_s']['max']:.4f} s; "
        f"warm p50 {out['ttft_warm_s']['p50']:.4f} s max {out['ttft_warm_s']['max']:.4f} s "
        f"(warm / cold p50 {out['warm_over_cold_p50']:.3f}; the warm engine's first, a miss, "
        f"{out['ttft_first_warm_engine_s']:.4f} s); mixed wave: {3 - ties} of 3 rows equal to "
        f"their cold references, {ties} parted at a tie; launches {launched}; on {smi}")
    return out


def phase_prefix(dev, smi, seed=0) -> dict:
    """The prefix KV cache on recipes A and D (module docstring, phase 9)."""
    t0 = time.time()
    out = {}
    for name, quantization, kv_dtype, layout, expected in RECIPES:
        if name in PREFIX_RECIPES:
            out[name] = prefix_recipe(dev, smi, name, quantization, kv_dtype, layout, expected, seed)
    launches = collections.Counter()
    for r in out.values():
        launches.update(r["launches"])
    log(f"phase prefix: ok ({time.time() - t0:.1f} s)")
    return {"recipes": {n: {k: v for k, v in r.items() if k != "launches"} for n, r in out.items()},
            "launches": dict(launches)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="kernels,model,serve,retrieval,rag,chains,prefix",
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
    retrieval, encoders = (phase_retrieval(dev, info["smi"], args.seed,
                                           keep="rag" in phases or "chains" in phases)
                           if "retrieval" in phases else ({}, None))
    rag, dep = (phase_rag(dev, info["smi"], args.seed, encoders, keep="chains" in phases)
                if "rag" in phases else ({}, None))
    chains = (phase_chains(dev, info["smi"], args.seed, dep, encoders)
              if "chains" in phases else {})
    prefix = phase_prefix(dev, info["smi"], args.seed) if "prefix" in phases else {}
    kernels = []
    for name, (replaces, source) in KERNELS.items():
        if name not in results:  # a check left out by --checks
            continue
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(sv["launches"][name] for sv in serves.values())
            + sum(ph.get("launches", {}).get(name, 0) for ph in (rag, chains, prefix)), **r,
        })
    log(f"total {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "serve": {
        name: {k: v for k, v in sv.items() if k != "launches"} for name, sv in serves.items()
    }, "retrieval": retrieval,
        "rag": {k: v for k, v in rag.items() if k != "launches"},
        "chains": {k: v for k, v in chains.items() if k != "launches"},
        "prefix": prefix.get("recipes", {})}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
