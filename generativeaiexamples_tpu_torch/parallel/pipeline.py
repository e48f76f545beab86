"""Pipeline parallelism without a KV cache: the GPipe schedule over the
``pipe`` axis.

Counterpart of generativeaiexamples_tpu/parallel/pipeline.py. The JAX
module runs one ``shard_map`` program whose devices each scan their own
block of layers and rotate activations with ``ppermute``; the port's one
controlling process runs the same schedule by hand: the decoder's layers
are cut into ``n_stages`` blocks (:func:`split_stages`), each placed on
its stage's device (:func:`shard_stages`), and at step ``i`` stage ``s``
works on microbatch ``i - s``, its input the previous stage's output of
the step before, copied to its device (:func:`pipeline_apply`). The
backward is autograd's, through the copies. Parameters are the port's
layered layout: a list of one dict a layer.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh

Params = Dict[str, Any]


def split_stages(layers: Sequence, n_stages: int) -> List[Sequence]:
    """``L`` per-layer entries -> ``n_stages`` consecutive slices of
    ``L / n_stages``."""
    L = len(layers)
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible by {n_stages} stages")
    per = L // n_stages
    return [layers[s * per:(s + 1) * per] for s in range(n_stages)]


def merge_stages(staged: Sequence[Sequence]) -> list:
    """Inverse of :func:`split_stages`."""
    return [lp for stage in staged for lp in stage]


def to_device(tree, device):
    """A layer's dict (int8 packs nested) with every tensor on ``device``
    (a no-op for a tensor already there)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def shard_stages(staged: Sequence[Sequence[Params]], mesh: Mesh) -> List[List[Params]]:
    """Each stage's layers on its pipe row's device (the stage's home)."""
    return [[to_device(lp, mesh.stage(s).home) for lp in stage] for s, stage in enumerate(staged)]


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    staged_params: Sequence,
    microbatches: torch.Tensor,  # [M, mb, T, D]
    mesh: Mesh,
    n_stages: int,
) -> torch.Tensor:
    """Run the ``M`` microbatches through ``n_stages`` stages; returns
    ``[M, mb, T, D]`` on the mesh's home device.

    ``stage_fn(stage_params, x) -> x`` applies one stage's layers. The
    schedule is GPipe's: at step ``i`` stage ``s`` works on microbatch ``i
    - s``; stage 0 takes microbatch ``i`` from ``microbatches``, stage ``s
    > 0`` the output stage ``s - 1`` made at step ``i - 1``, moved to its
    device; after ``M + n_stages - 1`` steps the last stage has emitted
    every microbatch."""
    M = microbatches.shape[0]
    homes = [mesh.stage(s).home for s in range(n_stages)]
    carry: List = [None] * n_stages
    outputs: List = [None] * M
    for i in range(M + n_stages - 1):
        step: List = [None] * n_stages
        for s in range(n_stages):
            mb = i - s
            if not 0 <= mb < M:
                continue
            x = microbatches[mb] if s == 0 else carry[s - 1]
            step[s] = stage_fn(staged_params[s], x.to(homes[s]))
            if s == n_stages - 1:
                outputs[mb] = step[s].to(mesh.home)
        carry = step
    return torch.stack(outputs)


def pipelined_decoder_forward(
    params: Params,
    cfg,
    tokens: torch.Tensor,  # [B, T]
    mesh: Mesh,
    n_stages: int,
    n_microbatches: int = 4,
    staged_layers=None,
) -> torch.Tensor:
    """The decoder's forward with its layers pipelined; f32 logits ``[B,
    T, V]``. The embedding and the head run on the home device; the body
    is cut over the pipe stages (pass ``staged_layers`` from
    :func:`split_stages` and :func:`shard_stages` to cut once). Causal
    plain attention, no KV cache: JAX's training and prefill path."""
    B, T = tokens.shape
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by {n_microbatches} microbatches")
    if staged_layers is None:
        staged_layers = shard_stages(split_stages(params["layers"], n_stages), mesh)

    def stage_fn(layers, h):
        mb = h.shape[0]
        pos = torch.arange(T, device=h.device).expand(mb, T)
        causal = pos[:, :, None] >= pos[:, None, :]

        def attn(q, k, v):
            return llama._attention(q, k, v, causal)

        for lp in layers:
            h = llama._block(h, lp, cfg, pos, attn)
        return h

    h = params["embed"][tokens.long()]
    h_micro = h.reshape(n_microbatches, B // n_microbatches, T, -1)
    h = pipeline_apply(stage_fn, staged_layers, h_micro, mesh, n_stages).reshape(B, T, -1)
    return llama._head(params, h, cfg)
