"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each one's failure makes the script exit non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build every CUDA kernel of the serving path from ``csrc/`` (nvcc, in
   parallel);
3. each kernel against its plain PyTorch version at the serving path's
   shapes for llama3-8b, with its time, the plain version's, one library
   call's as a yardstick, and its bound;
4. model level at full llama3-8b width and depth (int8 weights, random
   from a seed): one 512-token prefill and 8 decode steps on the kernel
   path and on the plain path, logits and greedy tokens compared;
5. serve: the port's LLMEngine behind its OpenAI-compatible HTTP server,
   a few concurrent requests (chat streaming and not, completions, one
   prompt longer than ``prefill_chunk``), with every kernel's launch count
   read before and after.

It then prints one JSON line of per-kernel results and, last, the device
line. It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

from generativeaiexamples_tpu_torch.ops import _build
from generativeaiexamples_tpu_torch.ops import flash_attention as fa
from generativeaiexamples_tpu_torch.ops import int8_matmul as im
from generativeaiexamples_tpu_torch.ops import page_attention as pa
from generativeaiexamples_tpu_torch.utils import hardware

MODEL = "llama3-8b"
REPLACES = {
    "int8_matmul": "generativeaiexamples_tpu/ops/int8_matmul.py:73",
    "paged_attention": "generativeaiexamples_tpu/ops/page_attention.py:88",
    "flash_attention_causal": "generativeaiexamples_tpu/ops/flash_attention.py:36",
}
SOURCES = {
    "int8_matmul": "generativeaiexamples_tpu_torch/csrc/int8_matmul.cu",
    "paged_attention": "generativeaiexamples_tpu_torch/csrc/page_attention.cu",
    "flash_attention_causal": "generativeaiexamples_tpu_torch/csrc/flash_attention.cu",
}
WRAPPERS = {
    "int8_matmul": im.int8_matmul,
    "paged_attention": pa.paged_attention,
    "flash_attention_causal": fa.flash_attention_causal,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


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
            if M == 8 and name != "lm_head":  # one decoder layer's projections at B=8
                agg["ms"] += k_ms
                agg["plain_ms"] += p_ms
                agg["library_ms"] += l_ms
                agg["bytes"] += nbytes
                agg["flops"] += flops
            del q, w
    b_ms, b_by = hardware.bound_ms(agg["bytes"], agg["flops"])
    results["int8_matmul"] = {
        "max_abs_err": agg["err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": agg["library_ms"],
        "shape": "one layer's wqkv+wo+w_gateup+w_down at M=8",
    }


def _ragged_case(gen, dev, B, Pmax, page, Hkv, Dh):
    """Ragged page tables over a shuffled pool: a dead row (position 0,
    scratch page), a one-page row, a full row, the rest mid-length."""
    positions = [0, 50, Pmax * page - 1] + [
        int(x) for x in torch.randint(200, 1200, (B - 3,), generator=gen, device=dev)
    ]
    live = [0] + [p // page + 1 for p in positions[1:]]
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
    return k, v, tables.to(dev), pos, positions


def check_paged(timer, dev, gen, results) -> None:
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    B, page, Pmax = 8, 128, 8192 // 128
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k, v, tables, pos, positions = _ragged_case(gen, dev, B, Pmax, page, Hkv, Dh)
    q = torch.randn((B, 1, Hq, Dh), generator=gen, device=dev).to(torch.bfloat16)
    out = pa.paged_attention(q, k, v, tables, pos)
    ref = pa.paged_attention_plain(q, k, v, tables, pos)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    tol = 1e-2  # outputs are convex mixes of N(0, 1) rows; bf16 rounding of |out| < 1 is < 4e-3
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("paged_attention returned non-finite values (dead row?)")
    k_ms = timer.ms(lambda: pa.paged_attention(q, k, v, tables, pos))
    p_ms = timer.ms(lambda: pa.paged_attention_plain(q, k, v, tables, pos), iters=5)
    # yardstick: SDPA over the rows' pre-gathered windows with a length mask
    S = Pmax * page
    gk = k[tables.long()].reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous()
    gv = v[tables.long()].reshape(B, S, Hkv, Dh).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :] <= pos.long()[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, gk, gv, attn_mask=mask, enable_gqa=True))
    nbytes, flops = hardware.paged_attention_cost([[p] for p in positions], Hq, Hkv, Dh, Pmax)
    b_ms, b_by = hardware.bound_ms(nbytes, flops)
    ok = err <= tol
    log(f"  paged_attention B={B} positions={positions}: max|err|={err:.4g} tol={tol} "
        f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("paged_attention disagrees with its plain version")
    results["paged_attention"] = {
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": l_ms,
        "shape": "B=8 decode rows over ragged tables, Hq=32 Hkv=8 Dh=128 page=128",
    }


def check_flash(timer, dev, gen, results) -> None:
    from generativeaiexamples_tpu_torch.models.llama import PRESETS

    cfg = PRESETS[MODEL]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = 0.0
    for B, T in ((2, 512), (2, 300)):
        q = torch.randn((B, T, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
        out = fa.flash_attention_causal(q, k, v)
        ref = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err = _max_err(out, ref)
        tol = 1e-2  # as for paged attention: |out| < ~3, f32 math, one bf16 rounding
        k_ms = timer.ms(lambda: fa.flash_attention_causal(q, k, v))
        p_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v), iters=5)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = timer.ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes, flops = hardware.flash_attention_cost(B, T, Hq, Hkv, D)
        b_ms, b_by = hardware.bound_ms(nbytes, flops)
        ok = err <= tol
        log(f"  flash_attention_causal B={B} T={T}: max|err|={err:.4g} tol={tol} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_causal T={T} disagrees with its plain version")
        worst = max(worst, err)
        if T == 512:
            results["flash_attention_causal"] = {
                "max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms,
                "shape": "B=2 T=512 Hq=32 Hkv=8 D=128",
            }
    results["flash_attention_causal"]["max_abs_err"] = worst


def phase_kernels(dev) -> dict:
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict = {}
    check_int8(timer, dev, gen, results)
    check_paged(timer, dev, gen, results)
    check_flash(timer, dev, gen, results)
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
    params = quant.init_packed_params_int8(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    tokens = torch.randint(0, 512, (B, T), generator=gen, device=dev)
    lengths_d = torch.tensor(lengths, device=dev)
    per_row = -(-(T + steps) // page)
    tables = (1 + torch.arange(B * per_row, device=dev, dtype=torch.int32)).reshape(B, per_row)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    def run(kernels: bool, forced=None):
        qk = None if kernels else False
        pool = llama.init_kv_pool(cfg, 1 + B * per_row, page, torch.bfloat16, dev)
        logits, kvs = llama.prefill_layers(
            params, cfg, tokens, lengths_d, use_flash=kernels, quant_kernel=qk
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
                page_size=page, quant_kernel=qk, page_kernel=kernels,
            )
            out.append(logits)
            pos = pos + 1
        torch.cuda.synchronize()
        return torch.stack(out), toks

    with torch.inference_mode():
        k_logits, k_toks = run(True)
        p_logits, _ = run(False, forced=k_toks)  # same inputs at every step
    if not bool(torch.isfinite(k_logits).all()):
        raise AssertionError("kernel path produced non-finite logits")
    diff = float((k_logits - p_logits).abs().max())
    top2 = torch.topk(p_logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = torch.argmax(k_logits, -1) == torch.argmax(p_logits, -1)
    decided = margin > LOGITS_TOL
    bad = int((decided & ~agree).sum())
    log(f"  model {MODEL} (L={cfg.num_layers}, hidden {cfg.hidden_size}, vocab {cfg.vocab_size}), "
        f"int8 weights: prefill B={B} T={T} + {steps} decode steps: max|dlogits|={diff:.4g} "
        f"tol={LOGITS_TOL} greedy agree {int(agree.sum())}/{agree.numel()} "
        f"(disagreements where margin > tol: {bad}) logits shape {tuple(k_logits.shape)}")
    if diff > LOGITS_TOL or bad:
        raise AssertionError("kernel path and plain path disagree at model level")
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
    B=8 (kernel path, 160-token contexts), CUDA events around each step with a ~0.1 s
    spin kernel queued ahead, so the host has enqueued the whole step
    before the device starts it: no launch gaps are timed. (torch.profiler
    does not see every launch of the ctypes-loaded kernels, so it is not
    used.)"""
    from generativeaiexamples_tpu_torch.models import llama

    cfg, dev, page = engine.model_config, engine.device, engine.engine_config.page_size
    B, per_row = engine.num_slots, 2
    pool = llama.init_kv_pool(cfg, 1 + B * per_row, page, torch.bfloat16, dev)
    tables = (1 + torch.arange(B * per_row, device=dev, dtype=torch.int32)).reshape(B, per_row)
    tokens = torch.arange(B, device=dev) * 31 % 250
    positions = torch.full((B,), 160, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)

    def step():
        logits, _ = llama.decode_layers_paged(
            engine.params, cfg, tokens, positions, live, tables, pool,
            window=per_row * page, page_size=page, page_kernel=True,
        )
        torch.argmax(logits, dim=-1)

    times = []
    with torch.inference_mode():
        step()
        for _ in range(5):
            torch.cuda._sleep(200_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return sorted(times)


def phase_serve(dev) -> dict:
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.engine.server import make_server

    t0 = time.time()
    config = EngineConfig(model_config_name=MODEL, quantization="int8")
    engine = LLMEngine(config, device=dev)
    log(f"  engine built ({time.time() - t0:.1f} s): {MODEL} int8 weights, bf16 paged pool "
        f"{engine._pool_pages} pages x {config.page_size}, max_batch_size "
        f"{config.max_batch_size}, prefill_chunk {config.prefill_chunk}, decode_block "
        f"{config.decode_block}")
    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="smoke-http", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    errors = []
    try:
        reset_counts()
        t_serve = time.time()
        results = {}

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
        assert long_ids > config.prefill_chunk, long_ids
        log(f"  HTTP: chat stream {len(frames) - 1} chunks + [DONE], chat, completions, "
            f"long chat ({long_ids} prompt ids, chunked prefill): all 200")

        # a full decode batch through the engine's own entry point, by ids
        before = engine.stats()
        prompts = [[256] + [(7 * i + j) % 250 for j in range(100 + 8 * i)] for i in range(8)]
        params = SamplingParams(temperature=0.0, max_tokens=64)
        queues = [engine.generate_ids(p, params) for p in prompts]
        counts_ids = []
        for q in queues:
            n = 0
            while q.get(timeout=600) is not None:
                n += 1
            counts_ids.append(n)
        after = engine.stats()
        stop_ids = set(engine.tokenizer.stop_ids())
        assert all(0 < n <= 64 for n in counts_ids), counts_ids
        t_total = time.time() - t_serve
        launched = counts()
        log(f"  generate_ids x8 (greedy, max_tokens 64): ids per request {counts_ids} "
            f"(fewer than 64 only when a stop id {sorted(stop_ids)} was drawn)")
        missing = [n for n, c in launched.items() if c == 0]
        if missing:
            raise AssertionError(f"kernels never launched while serving: {missing}")
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
        }
        log(f"  launches while serving: {launched}")
        samples = device_step_ms(engine)
        serve["device_step_ms"] = statistics.median(samples)
        serve["device_step_ms_samples"] = samples
        serve["device_idle_share"] = max(0.0, 1.0 - serve["device_step_ms"] / serve["decode_step_ms"])
        log(f"  decode at B=8: {serve['decode_tokens_per_s']:.1f} tokens/s, step "
            f"{serve['decode_step_ms']:.2f} ms (wall time of decode blocks on the dispatch "
            f"thread); MFU {serve['decode_mfu']:.2%}, weight streaming at "
            f"{serve['decode_weight_hbm_share']:.1%} of peak HBM rate; one step on the device "
            f"{serve['device_step_ms']:.2f} ms (median of {', '.join(f'{t:.2f}' for t in samples)}; "
            f"idle {serve['device_idle_share']:.1%}); TTFT mean {serve['ttft_mean_s']:.3f} s max {serve['ttft_max_s']:.3f} s "
            f"over all requests")
        log(f"phase serve: ok ({time.time() - t0:.1f} s)")
        return serve
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    info = phase_device()
    phase_build()
    results = phase_kernels(dev)
    phase_model(dev)
    serve = phase_serve(dev)
    kernels = []
    for name in WRAPPERS:
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": serve["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
        })
    print(json.dumps({"kernels": kernels, "serve": {
        k: v for k, v in serve.items() if k != "launches"}}), flush=True)
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
