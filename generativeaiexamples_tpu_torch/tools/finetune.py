"""Fine-tuning CLI: SFT and LoRA on the Llama decoder, on one device.

Counterpart of the JAX repository's tools/finetune.py, flag for flag,
plus ``--device`` (default ``cuda``; ``cpu`` for the CPU):

    python -m generativeaiexamples_tpu_torch.tools.finetune --model debug \\
        --data data.jsonl --mode lora --rank 8 --steps 100 --ckpt-dir ckpts/

- data: JSONL with {"prompt", "response"} (loss on response tokens only)
  or {"text"} (loss everywhere); the rows and the batch order are JAX's
  for the same data and seed;
- model: a models/llama.py preset (random weights from ``--seed``) or a
  HF checkpoint directory (models/hf_loader.py);
- checkpoint/resume: models/checkpoint.py, step-numbered, ``--resume``
  picks up the latest;
- LoRA: ``--merge-out`` writes the base + adapter merged weights in JAX's
  npz layout (``layers/wq`` stacked on a layer axis, f32), which each
  package's ``load_merged`` reads.

Training runs on one device: ``--tp -1`` (the default) resolves to one,
and ``--tp``, ``--dp`` or ``--sp`` above 1 raise at start (sharded
training is ROADMAP queue 1 item 15). The last line of standard output is
``{"final_loss": ..., "steps": ...}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

SHARDED = "sharded training (--tp/--dp/--sp above 1) is ROADMAP queue 1 item 15; this CLI trains on one device"


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="SFT / LoRA fine-tuning on one device")
    p.add_argument("--model", default="debug", help="preset name or HF checkpoint dir")
    p.add_argument("--data", required=True, help="JSONL training data")
    p.add_argument("--mode", choices=["sft", "lora"], default="lora")
    p.add_argument("--tokenizer", default=None, help="tokenizer.json path (default: bytes)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--rank", type=int, default=16, help="LoRA rank")
    p.add_argument("--alpha", type=float, default=32.0, help="LoRA alpha")
    p.add_argument(
        "--targets", default="wq,wk,wv,wo", help="comma-separated LoRA target projections"
    )
    p.add_argument("--tp", type=int, default=-1, help="tensor parallelism (-1 = one device)")
    p.add_argument("--dp", type=int, default=1, help="data parallelism")
    p.add_argument("--sp", type=int, default=1, help="sequence parallelism")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--merge-out", default=None, help="write merged LoRA weights here (npz)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p.parse_args(argv)


def load_examples(path: str) -> List[Dict[str, str]]:
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    if not out:
        raise ValueError(f"No examples in {path}")
    return out


def tokenize_examples(
    examples: List[Dict[str, str]], tokenizer, seq_len: int
) -> List[Dict[str, np.ndarray]]:
    """Fixed-length rows: tokens [T] and loss_mask [T] (1.0 on supervised
    positions — response tokens for prompt/response pairs, all for text)."""
    rows = []
    pad = tokenizer.pad_id
    for ex in examples:
        if "text" in ex:
            ids = tokenizer.encode(ex["text"], add_bos=True)
            mask_from = 1  # supervise everything after BOS
        else:
            prompt_ids = tokenizer.encode(ex["prompt"], add_bos=True)
            full_ids = prompt_ids + tokenizer.encode(ex["response"])
            ids, mask_from = full_ids, len(prompt_ids)
        ids = ids[:seq_len]
        mask = np.zeros(seq_len, np.float32)
        mask[min(mask_from, seq_len): len(ids)] = 1.0
        tokens = np.full(seq_len, pad, np.int32)
        tokens[: len(ids)] = ids
        if mask.sum() == 0:
            continue
        rows.append({"tokens": tokens, "loss_mask": mask})
    if not rows:
        raise ValueError("All examples were empty after tokenization")
    return rows


def batches(
    rows: List[Dict[str, np.ndarray]], batch_size: int, seed: int
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.permutation(len(rows))
        for start in range(0, len(rows) - batch_size + 1, batch_size):
            chosen = [rows[i] for i in idx[start: start + batch_size]]
            yield {
                "tokens": np.stack([r["tokens"] for r in chosen]),
                "loss_mask": np.stack([r["loss_mask"] for r in chosen]),
            }
        if len(rows) < batch_size:  # tiny datasets: sample with replacement
            chosen = [rows[i] for i in rng.integers(0, len(rows), batch_size)]
            yield {
                "tokens": np.stack([r["tokens"] for r in chosen]),
                "loss_mask": np.stack([r["loss_mask"] for r in chosen]),
            }


def resolve_device(args: argparse.Namespace) -> torch.device:
    """The one device training runs on; a mesh of more than one device
    raises (item 15), and ``cuda`` without a card raises."""
    for flag in ("tp", "dp", "sp"):
        if getattr(args, flag) > 1:
            raise SystemExit(f"--{flag} {getattr(args, flag)}: {SHARDED}")
    if args.tp not in (-1, 1) or args.dp < 1 or args.sp < 1:
        raise SystemExit(f"--tp must be -1 or >= 1, --dp and --sp >= 1 (got {args.tp}, {args.dp}, {args.sp})")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible (pass --device cpu for the CPU)")
    return device


def main(argv: List[str] | None = None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    device = resolve_device(args)

    from generativeaiexamples_tpu_torch.engine.tokenizer import load_tokenizer
    from generativeaiexamples_tpu_torch.models import hf_loader, llama, lora
    from generativeaiexamples_tpu_torch.models.checkpoint import CheckpointManager
    from generativeaiexamples_tpu_torch.models.train import (
        TrainState,
        make_lora_train_step,
        make_optimizer,
        make_train_step,
        trainable,
    )

    tokenizer = load_tokenizer(args.tokenizer)
    rows = tokenize_examples(load_examples(args.data), tokenizer, args.seq_len)
    print(f"dataset: {len(rows)} usable rows", file=sys.stderr)

    if args.model in llama.PRESETS:
        cfg = llama.PRESETS[args.model]
        base_params = llama.init_params(cfg, args.seed, torch.bfloat16, device)
    else:
        cfg = hf_loader.config_from_hf(args.model)
        if cfg is None:
            raise SystemExit(f"--model {args.model!r} is neither a preset nor a HF dir")
        base_params = hf_loader.load_params(args.model, cfg, torch.bfloat16, device)

    optimizer = make_optimizer(learning_rate=args.lr)
    if args.mode == "lora":
        lora_cfg = lora.LoRAConfig(
            rank=args.rank, alpha=args.alpha,
            targets=tuple(t.strip() for t in args.targets.split(",") if t.strip()),
        )
        gen = torch.Generator(device=device).manual_seed(args.seed)
        trainable_params = trainable(lora.init_lora_params(cfg, lora_cfg, gen, torch.bfloat16, device))
        lora_step = make_lora_train_step(cfg, lora_cfg, optimizer)
        step_fn = lambda state, batch: lora_step(state, base_params, batch)  # noqa: E731
        print(
            f"LoRA r={lora_cfg.rank} targets={lora_cfg.targets}: "
            f"{lora.count_lora_params(trainable_params):,} trainable / "
            f"{llama.count_params(base_params):,} total",
            file=sys.stderr,
        )
    else:
        trainable_params = trainable(base_params)
        step_fn = make_train_step(cfg, optimizer)

    state = TrainState(
        params=trainable_params,
        opt_state=optimizer.init(trainable_params),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = int(state.step)
        print(f"resumed from step {start_step}", file=sys.stderr)

    it = batches(rows, args.batch_size, args.seed)
    t0 = time.time()
    loss = None
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        state, loss = step_fn(state, batch)
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            dt = time.time() - t0
            print(
                f"step {step + 1}/{args.steps} loss={float(loss):.4f} "
                f"({(step + 1 - start_step) / dt:.2f} steps/s)",
                file=sys.stderr,
            )
        if ckpt and (step + 1) % args.save_every == 0:
            ckpt.save(step + 1, state)

    if ckpt:
        ckpt.save(args.steps, state, wait=True)
        ckpt.close()

    if args.mode == "lora" and args.merge_out:
        merged = lora.merge(base_params, state.params, lora_cfg)
        save_merged(args.merge_out, merged)
        print(f"merged weights written to {args.merge_out}", file=sys.stderr)

    if loss is not None:
        print(json.dumps({"final_loss": float(loss), "steps": args.steps}))
    return 0


def save_merged(path: str, params) -> None:
    """The parameter tree as JAX's npz: ``embed``, ``final_norm``,
    ``lm_head`` and ``layers/<key>`` stacked on a leading layer axis, f32."""
    flat = {k: v.detach().float().cpu().numpy() for k, v in params.items() if k != "layers"}
    for key in params["layers"][0]:
        flat[f"layers/{key}"] = np.stack(
            [lp[key].detach().float().cpu().numpy() for lp in params["layers"]])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_merged(path: str, dtype=torch.bfloat16, device="cpu"):
    """Inverse of save_merged (and of JAX's): npz → the port's tree, one
    dict a layer, in ``dtype`` on ``device``."""
    out: Dict = {"layers": None}
    stacked: Dict[str, np.ndarray] = {}
    with np.load(path) as data:
        for name in data.files:
            if name.startswith("layers/"):
                stacked[name[len("layers/"):]] = data[name]
            else:
                out[name] = torch.from_numpy(data[name]).to(device=device, dtype=dtype)
    L = len(next(iter(stacked.values())))
    out["layers"] = [
        {k: torch.from_numpy(v[i]).to(device=device, dtype=dtype) for k, v in stacked.items()}
        for i in range(L)
    ]
    return out


if __name__ == "__main__":
    raise SystemExit(main())
