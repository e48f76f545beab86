"""Process-group workers for the port's multi-process tests
(tests/test_torch_multihost.py, tests/test_torch_train_sharded.py).

Each worker runs in a process of its own, started by :func:`run_group`
under ``torch.multiprocessing``'s ``spawn`` (a clean interpreter: this
module imports torch and the port only, never jax), joins a ``gloo``
group over loopback through ``multihost.initialize_distributed``, and
puts ``(rank, "ok" | "error", payload)`` on a queue. :func:`run_group`
holds the whole group to a wall-clock limit of its own, so a hung child
fails its test instead of eating the suite's clock.
"""
from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from generativeaiexamples_tpu_torch.tools import launch

GROUP_LIMIT_S = 60.0


def run_group(target, n: int, *args, expect: int = None, limit_s: float = GROUP_LIMIT_S):
    """Start ``n`` processes of ``target(rank, port, n, queue, *args)``
    and collect ``expect`` (default ``n``) results; every process is
    joined, or killed, before this returns. Returns ``({rank: (status,
    payload)}, seconds)``; raises AssertionError past ``limit_s``."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = launch.free_port()
    start = time.monotonic()
    procs = [ctx.Process(target=target, args=(r, port, n, q, *args), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < (n if expect is None else expect):
            left = limit_s - (time.monotonic() - start)
            if left <= 0:
                raise AssertionError(f"the group did not answer within {limit_s} s: {results}")
            try:
                rank, status, payload = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                continue
            results[rank] = (status, payload)
        for p in procs:
            p.join(max(0.1, limit_s - (time.monotonic() - start)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return results, time.monotonic() - start


@contextlib.contextmanager
def one_thread():
    """One GEMM thread, in every process of a group and in its in-process
    twin, so both sum each dot product in the same order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def group_worker(rank: int, port: int, n: int, q, die_rank=None, timeout_s: float = 30.0):
    """Join the group, all-reduce ``rank + 1``, pass a barrier; the rank
    ``die_rank`` exits at once after joining instead."""
    from generativeaiexamples_tpu_torch.parallel import multihost

    try:
        multihost.initialize_distributed(f"127.0.0.1:{port}", n, rank, timeout_s=timeout_s)
        out = {"backend": multihost.backend(), "count": multihost.process_count(),
               "index": multihost.process_index(), "device": str(multihost.local_device())}
        if rank == die_rank:
            os._exit(7)
        start = time.monotonic()
        out["sum"] = multihost.all_reduce_sum(torch.full((3,), float(rank + 1))).tolist()
        multihost.barrier()
        out["seconds"] = time.monotonic() - start
        q.put((rank, "ok", out))
    except Exception:  # noqa: BLE001 - the test reads the error
        q.put((rank, "error", traceback.format_exc()))
    finally:
        multihost.shutdown()


def lone_worker(rank: int, port: int, n: int, q, timeout_s: float):
    """Rank 0 of a group of two whose rank 1 never comes."""
    group_worker(0, port, 2, q, timeout_s=timeout_s)


def lora_setup(seq: int = 32):
    """The debug-8dev LoRA problem the DP tests share, at f32: base, all
    seven targets' adapters with B nonzero, four rows of tokens and a
    mask, the optimizer."""
    from generativeaiexamples_tpu_torch.models import llama, lora, train

    cfg = llama.PRESETS["debug-8dev"]
    base = llama.init_params(cfg, 0, torch.float32)
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, targets=tuple(lora._TARGET_DIMS))
    adapters = lora.init_lora_params(cfg, lcfg, torch.Generator().manual_seed(1), torch.float32)
    gen = torch.Generator().manual_seed(2)
    adapters = [{k: v if k.endswith("_a") else torch.randn(v.shape, generator=gen) * 0.05
                 for k, v in lp.items()} for lp in adapters]
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(1, cfg.vocab_size, (4, seq)).astype(np.int32)),
                "loss_mask": torch.from_numpy((rng.random((4, seq)) < 0.7).astype(np.float32))}
               for _ in range(3)]
    return cfg, lcfg, base, adapters, batches, train.make_optimizer(learning_rate=1e-2)


def lora_steps(mesh, rows=slice(None)):
    """Three LoRA steps on ``mesh`` over ``rows`` of each batch: the
    losses and the adapters after them, whole, as numpy."""
    from generativeaiexamples_tpu_torch.models import lora, train
    from generativeaiexamples_tpu_torch.parallel import sharding

    cfg, lcfg, base, adapters, batches, opt = lora_setup()
    params = train.trainable(lora.shard_lora_params(adapters, lcfg, mesh))
    state = train.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
    step = train.make_lora_train_step(cfg, lcfg, opt, False, mesh)
    base = sharding.shard_params(base, mesh)
    losses = []
    with one_thread():
        for batch in batches:
            state, loss = step(state, base, {k: v[rows] for k, v in batch.items()})
            losses.append(float(loss))
    whole = sharding.unshard(state.params, "cpu")
    return losses, [t.detach().numpy() for t in train.tree_leaves(whole)]


def lora_dp_worker(rank: int, port: int, n: int, q):
    """One data replica of a DP=n LoRA run: the hybrid mesh of one
    ``cpu`` device a process, this process's ``local_batch_slice`` of
    each batch, the gradients all-reduced over ``gloo``."""
    from generativeaiexamples_tpu_torch.parallel import multihost

    try:
        multihost.initialize_distributed(f"127.0.0.1:{port}", n, rank, timeout_s=30.0)
        mesh = multihost.create_hybrid_mesh(devices=["cpu"] * n)
        local = multihost.local_batch_slice(4, mesh)
        losses, leaves = lora_steps(mesh, slice(rank * local, (rank + 1) * local))
        q.put((rank, "ok", {"losses": losses, "leaves": leaves, "backend": multihost.backend(),
                            "mesh": mesh.shape, "calls": multihost.COLLECTIVE_STATS["all_reduce_calls"]}))
    except Exception:  # noqa: BLE001 - the test reads the error
        q.put((rank, "error", traceback.format_exc()))
    finally:
        multihost.shutdown()
