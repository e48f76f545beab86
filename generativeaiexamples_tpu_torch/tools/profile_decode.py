"""Profile steady-state decode on the card.

Counterpart of the JAX repository's tools/profile_decode.py: it builds the
engine that script builds (the same ``BENCH_*`` variables, ``BENCH_TP``
included, so a sharded engine profiles too), fills every slot, and traces
``PROFILE_SECONDS`` of steady-state decode with ``torch.profiler``
(utils/profiling.py ``TraceWindow``: CPU of every thread, CUDA on the
card). The device track is read by utils/device_trace.py: device time by
kernel (the port's kernels by name, PyTorch's under ``torch``), by JAX's
categories (``pallas-kernel``, ``cache-scatter``, ``copy/layout``,
``sampling``, ``collective``, ``fusion/matmul``, ``other``; the TP row
reduce's kernels are ``collective``), the top 25 kernels, the
inter-dispatch idle (the traced wall less the union of the device
events), the decode steps in the window and ``complete`` (whether the
trace holds every port kernel the wrappers launched; an incomplete trace
gives no figures).

JAX's ``engine.warmup(...)`` has no counterpart (the port compiles nothing
at serving time): one short untraced request loads the kernels instead.

    BENCH_MODEL=llama3-8b BENCH_BATCH=96 BENCH_KV=bfloat16 \\
        python -m generativeaiexamples_tpu_torch.tools.profile_decode

It runs on the card: with no card it raises unless ``--device cpu`` is
given, and on the CPU the device figures are ``not_measured``. The
Chrome trace is written under ``PROFILE_DIR`` (default: a new temporary
directory). The last line of standard output is the report as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

os.environ.setdefault("LOGLEVEL", "WARNING")

import torch  # noqa: E402

from generativeaiexamples_tpu_torch.config import EngineConfig  # noqa: E402
from generativeaiexamples_tpu_torch.utils import device_trace, profiling  # noqa: E402

TOP_OPS = 25


def engine_config(environ=None) -> EngineConfig:
    """The JAX script's engine config from the same variables."""
    env = os.environ if environ is None else environ
    paged_kernel = env.get("BENCH_PAGED_KERNEL", "auto")
    if paged_kernel != "auto":
        raise ValueError(f"BENCH_PAGED_KERNEL={paged_kernel}: the port always reads a paged "
                         "pool through its kernel on the card")
    return EngineConfig(
        model_config_name=env.get("BENCH_MODEL", "llama3-8b"),
        max_batch_size=int(env.get("BENCH_BATCH", "96")),
        max_seq_len=int(env.get("BENCH_SEQ", "512")),
        prefill_chunk=128,
        tensor_parallelism=int(env.get("BENCH_TP", "-1")),
        dtype="bfloat16",
        decode_block=int(env.get("BENCH_BLOCK", "8")),
        quantization=env.get("BENCH_QUANT", "int8"),
        kv_cache_dtype=env.get("BENCH_KV", "bfloat16"),
        kv_layout=env.get("BENCH_KV_LAYOUT", "auto"),
        spec_decode_enable=env.get("BENCH_SPEC", "off"),
        scheduler_policy=env.get("BENCH_SCHED", "unified"),
    )


def build_engine(cfg: EngineConfig, device: Optional[str] = None):
    """The engine on the card (``device=None``: the visible cards,
    ``tensor_parallelism`` of them), or on the CPU (``"cpu"``: N CPU
    shards for ``BENCH_TP`` N). No card and no device raises."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.parallel import create_mesh

    if device is None and not torch.cuda.is_available():
        raise RuntimeError("profile_decode profiles the card and none is visible; "
                           "pass --device cpu to run it on the CPU (no device figures)")
    if device is not None and torch.device(device).type == "cpu" and cfg.tensor_parallelism > 1:
        n = cfg.tensor_parallelism
        return LLMEngine(cfg, mesh=create_mesh(n, devices=["cpu"] * n))
    return LLMEngine(cfg, device=device)


def _report(win, extra: Dict[str, Any]) -> Dict[str, Any]:
    """A window's reading: the analysis, the idle, the top kernels."""
    res = dict(win.result)
    busy, wall = res.get("busy_ms"), res.get("wall_ms")
    res["idle_ms"] = None if busy is None else max(0.0, wall - busy)
    res["top_ops"] = None
    if busy is not None:
        ops: Dict[str, List[float]] = {}
        for name, a, b in win.events:
            ops.setdefault(name, [0.0, 0])
            ops[name][0] += (b - a) / 1e3
            ops[name][1] += 1
        top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
        res["top_ops"] = [{"name": n, "ms": ms, "count": c, "category": device_trace.categorize(n)}
                          for n, (ms, c) in top]
        counts: Dict[str, int] = {}
        for name, _, _ in win.events:
            m = device_trace.PORT_KERNEL_NAMES.search(name)
            fam = m.group(0) if m else "torch"
            counts[fam] = counts.get(fam, 0) + 1
        res["kernel_counts"] = dict(sorted(counts.items()))
    res.update(extra)
    return res


def _warm(engine, prompt: Sequence[int]) -> None:
    """One short untraced request: every kernel of the path loaded."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    list(engine.iter_ids(prompt, SamplingParams(temperature=0.0, max_tokens=8), timeout=900))


def profile_decode(engine, seconds: float = 1.0, prompt_tokens: int = 128,
                   log_dir: Optional[str] = None) -> Dict[str, Any]:
    """Trace ``seconds`` of steady-state decode: every slot filled behind
    ``hold_admissions`` (two waves of long-budget greedy requests, so the
    slots stay full), the window opened once every slot decodes."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    B = engine.num_slots
    prompt = list(range(5, 5 + prompt_tokens - 1))
    _warm(engine, prompt)
    params = SamplingParams(temperature=0.0, max_tokens=engine.max_seq_len - prompt_tokens - 2)
    with engine.hold_admissions():
        reqs = [engine.submit([7 + i] + prompt, params) for i in range(2 * B)]
    deadline = time.time() + 120
    while time.time() < deadline:
        with engine._lock:
            if len(engine._slot_req) == B:
                break
        time.sleep(0.2)
    time.sleep(0.5)
    steps0 = engine.stats()["decode_steps"]
    with profiling.TraceWindow(log_dir) as win:
        time.sleep(seconds)
    steps = engine.stats()["decode_steps"] - steps0
    for req in reqs:
        engine.abort(req)
    if steps == 0:
        print("WARNING: zero decode steps in the traced window; the engine drained before "
              "tracing: raise BENCH_SEQ or the request count", file=sys.stderr)
    return _report(win, {"window": "decode", "decode_steps": steps, "slots": B,
                         "shards": engine.tp_shards, "decode_block": engine._decode_block})


def profile_prefill(engine, prompt_tokens: int = 512,
                    log_dir: Optional[str] = None) -> Dict[str, Any]:
    """Trace one request's prefill, from its submit to its first token, on
    an idle engine (a ``prompt_tokens`` prompt: one prefill bucket of that
    size where ``prefill_chunk`` holds it)."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    prompt = [(i * 37) % 199 + 1 for i in range(prompt_tokens)]
    # another first id: the traced prompt must not hit the warm one's prefix
    _warm(engine, [prompt[0] + 1] + prompt[1:])
    with profiling.TraceWindow(log_dir) as win:
        req = engine.submit(prompt, SamplingParams(temperature=0.0, max_tokens=1))
        while req.out_queue.get(timeout=600) is not None:
            pass
    return _report(win, {"window": "prefill", "prompt_tokens": prompt_tokens,
                         "shards": engine.tp_shards})


def print_report(report: Dict[str, Any], out=None) -> None:
    """The JAX script's three tables, and the window's idle and steps
    (on ``out``, default standard output)."""
    def say(line=""):
        print(line, file=out or sys.stdout)

    wall = report["wall_ms"]
    say(f"trace: {report.get('trace')}")
    say(f"window {report['window']} on {report['shards']} shard(s): {wall:.1f} ms traced, "
        f"complete {report['complete']}"
        + (f", ~{report['decode_steps']} decode steps (block={report['decode_block']})"
           if report["window"] == "decode" else f", {report['prompt_tokens']} prompt tokens"))
    if report["busy_ms"] is None:
        say(f"device figures not measured: {report['not_measured']}")
        return
    say("\n== kernels (device time) ==")
    for name, ms in sorted(report["kernels_ms"].items(), key=lambda x: -x[1]):
        say(f"  {name:<40} {ms:9.2f} ms  x{report['kernel_counts'].get(name, 0):<6}"
            f" ({ms / max(wall, 1e-9) * 100:5.1f}% of traced wall)")
    say("\n== op categories ==")
    total = sum(report["categories_ms"].values())
    for cat, ms in sorted(report["categories_ms"].items(), key=lambda x: -x[1]):
        say(f"  {cat:<16} {ms:9.2f} ms ({ms / max(total, 1e-9) * 100:5.1f}%)")
    say(f"\nops-total {total:.2f} ms vs busy {report['busy_ms']:.2f} ms vs traced wall "
        f"{wall:.2f} ms -> inter-dispatch idle ~{report['idle_ms']:.2f} ms "
        f"({report['idle_share']:.1%})")
    say(f"\n== top {TOP_OPS} ops ==")
    for op in report["top_ops"]:
        say(f"  {op['ms']:9.2f} ms x{op['count']:<6} [{op['category']:<14}] {op['name'][:90]}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu runs the engine on the CPU (no device figures); "
                             "default: the card, raising when there is none")
    args = parser.parse_args(argv)
    engine = build_engine(engine_config(), args.device)
    try:
        log_dir = os.environ.get("PROFILE_DIR") or tempfile.mkdtemp(prefix="decode_profile_")
        report = profile_decode(engine, float(os.environ.get("PROFILE_SECONDS", "1.0")),
                                int(os.environ.get("BENCH_PROMPT", "128")), log_dir)
        print_report(report)
        print(json.dumps(report), flush=True)
    finally:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
