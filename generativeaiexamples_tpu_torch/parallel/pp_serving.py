"""Pipeline-parallel serving: PP x TP prefill and decode over a (pipe,
model) mesh.

Counterpart of generativeaiexamples_tpu/parallel/pp_serving.py. The JAX
module runs one SPMD ``shard_map`` program in which every stage computes
every iteration of the stage walk (the "ghost" iterations, their cache
writes masked) and ``ppermute`` hands the activation round the ring. The
port's one controlling process walks the stages in order instead:

1. stage ``s`` runs only its own ``L / stages`` layers, on its own
   ``model`` sub-mesh (parallel/mesh.py ``Mesh.stage``) with its own
   ``TPContext`` (parallel/tp_kernels.py), over its own layers' caches;
2. its activation goes to stage ``s + 1``'s home device (a
   device-to-device copy, or none where both stages sit on one card);
3. the final norm, the head and sampling run on stage 0's home, where the
   embedding and ``lm_head`` live, as in JAX, whose logits are stage 0's.

Without the ghost iterations the result is the same function. Each stage
runs the hand-written kernels on its local tiles, as a TP engine does:
``int8_matmul`` or ``int8_w8a8_matmul`` for the projections and the head,
``flash_attention_causal`` for the prompt's own attention, and
``decode_attention`` over an int8 fixed cache (JAX's PP program runs
XLA's dequantized dot and the einsum attention there: Pallas is opaque
inside it).

Weights (:func:`stage_params`): the parameter tree keeps ``layers`` a flat
list of the model's layers, layer ``i`` placed on its stage's sub-mesh
(cut into its shards by parallel/sharding.py, in the per-shard int8 layout
of ops/quant.py where the stage has more than one shard);
``pipeline.split_stages`` gives each stage its slice. The caches
(:func:`init_cache`) are the fixed layout of
``models/llama.init_kv_cache_layers``, one cache a layer on its stage's
devices: bf16 strips ``[slots, S, Hkv/tp, Dh]`` or int8 head-major
``[slots, Hkv/tp, S, Dh]`` with f32 scales ``[slots, Hkv/tp, 1, S]``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch

from generativeaiexamples_tpu_torch.models import llama
from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.parallel import sharding, tp_kernels
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh
from generativeaiexamples_tpu_torch.parallel.pipeline import split_stages, to_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PPContext:
    """Everything the serving steps need for the PP x TP walk: the mesh,
    its stage and shard counts, each stage's ``TPContext`` (None for a
    stage of one shard) and the packed product's mode (``quant_kernel``,
    as ``llama._proj`` takes it)."""

    mesh: Mesh
    stages: int  # pipe axis size
    tp: int  # model axis size
    quant_kernel: Any = None
    # the profiling label factory of each stage's row reduce
    annotate: Optional[Callable] = dataclasses.field(default=None, compare=False, repr=False)
    tps: tuple = dataclasses.field(init=False, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self.mesh.shape.get("pipe", 1) != self.stages or self.mesh.tp != self.tp:
            raise ValueError(f"PPContext: pipe={self.stages} x model={self.tp} on {self.mesh}")
        extra = {} if self.annotate is None else {"annotate": self.annotate}
        object.__setattr__(self, "tps", tuple(
            tp_kernels.TPContext(self.mesh.stage(s), self.tp, **extra) if self.tp > 1 else None
            for s in range(self.stages)
        ))

    def home(self, s: int) -> torch.device:
        """Stage ``s``'s first device: where its activations arrive."""
        return self.mesh.stage(s).home


def _stage_scope(ctx: PPContext, s: int):
    """The CUDA device stage ``s``'s launches go to: the ctypes wrappers
    launch on the thread's current device (as ``tp_kernels._scope`` for a
    shard), so a stage enters its home card, which need not be the
    caller's; a stage of shards on several cards enters each shard's in
    turn within it."""
    dev = ctx.home(s)
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def supported(cfg, stages: int, tp: int) -> bool:
    """Every sharded axis must divide evenly: layers over stages, heads /
    MLP width / vocab / hidden over the model axis."""
    return (
        stages > 1
        and cfg.num_layers % stages == 0
        and cfg.num_heads % tp == 0
        and cfg.num_kv_heads % tp == 0
        and cfg.intermediate_size % tp == 0
        and cfg.vocab_size % tp == 0
        and cfg.hidden_size % tp == 0
    )


def max_tp(cfg, n_devices: int) -> int:
    """Largest model-axis width the architecture admits on n devices
    (the TP cap PP exists to get past)."""
    t = math.gcd(
        math.gcd(cfg.num_heads, cfg.num_kv_heads),
        math.gcd(cfg.intermediate_size, math.gcd(cfg.vocab_size, cfg.hidden_size)),
    )
    return math.gcd(t, n_devices)


def stage_layer(lp: Dict[str, Any], ctx: PPContext, s: int, repack_cfg=None) -> Dict[str, Any]:
    """One layer of stage ``s``: moved to its device, or, on a stage of
    more than one shard, laid out per shard first (with ``repack_cfg``, the
    model config, from a single-device tree) and cut on its sub-mesh."""
    if ctx.tp == 1:
        return to_device(lp, ctx.home(s))
    if repack_cfg is not None:
        lp = quant.repack_layer_int8(lp, repack_cfg, ctx.tp)
    return sharding.shard_layer(lp, ctx.mesh.stage(s))


def stage_head(head, ctx: PPContext, repack_cfg=None):
    """``lm_head`` on stage 0: cut on its output axis over stage 0's
    shards (laid out per shard first with ``repack_cfg``), or whole."""
    if ctx.tp == 1:
        return to_device(head, ctx.home(0))
    if repack_cfg is not None and isinstance(head, dict):
        head = quant.repack_int8(head, repack_cfg.hidden_size, ctx.tp, "column")
    return sharding.shard_params({"lm_head": head}, ctx.mesh.stage(0))["lm_head"]


def stage_params(params: Params, ctx: PPContext, repack_cfg=None) -> Params:
    """The tree placed for the PP x TP walk: layer ``i`` on stage ``i //
    (L / stages)`` (:func:`stage_layer`), ``embed`` and ``final_norm`` whole
    on stage 0's home, ``lm_head`` over stage 0's shards. ``params`` is in
    the stages' per-shard layout, or, with ``repack_cfg`` (the model
    config), a single-device tree laid out again one layer at a time, so
    one random tree serves every (stages, tp)."""
    out: Params = {}
    for key, val in params.items():
        if key == "layers":
            out["layers"] = [
                stage_layer(lp, ctx, s, repack_cfg)
                for s, part in enumerate(split_stages(val, ctx.stages)) for lp in part
            ]
        elif key == "lm_head":
            out["lm_head"] = stage_head(val, ctx, repack_cfg)
        else:
            out[key] = val.to(ctx.home(0))
    return out


def init_cache(cfg, ctx: PPContext, num_slots: int, max_seq_len: int, dtype,
               quantized: bool = False) -> list:
    """The fixed-layout caches, one a layer, each on its stage's devices
    (cut on its KV heads over the stage's shards):
    ``models/llama.init_kv_cache_layers`` a stage."""
    stage_cfg = dataclasses.replace(cfg, num_layers=cfg.num_layers // ctx.stages)
    out: list = []
    for s in range(ctx.stages):
        out += llama.init_kv_cache_layers(stage_cfg, num_slots, max_seq_len, dtype, ctx.home(s),
                                          quantized=quantized, tp=ctx.tps[s])
    return out


def build_prefill(cfg, ctx: PPContext, use_flash: Optional[bool] = None):
    """As JAX's: returns ``prefill(params, cache, tokens, lengths, slots) ->
    (last-token logits [N, V], cache)`` for a monolithic wave of
    right-padded prompts ``tokens`` ``[N, T]`` of ``lengths`` into
    ``slots``. Each stage runs its layers on the prompt (causal attention
    within it: flash where the kernel serves the stage's local heads) and
    writes its layers' K/V rows at ``[slot, 0:T]`` of its caches (int8
    caches quantize on the write); the logits are f32, on stage 0's home."""

    def prefill(params: Params, cache: list, tokens: torch.Tensor, lengths: torch.Tensor,
                slots: torch.Tensor):
        N, T = tokens.shape
        positions = torch.arange(T, device=tokens.device).expand(N, T)
        h = params["embed"][tokens]
        stages = zip(split_stages(params["layers"], ctx.stages), split_stages(cache, ctx.stages))
        for s, (layers, caches) in enumerate(stages):
            dev = ctx.home(s)
            with _stage_scope(ctx, s):
                h, kvs = llama.prefill_stage(layers, cfg, h.to(dev), positions.to(dev), use_flash,
                                             ctx.quant_kernel, ctx.tps[s])
                llama.write_prefill_slots(caches, kvs, slots.to(dev), tp=ctx.tps[s])
            del kvs
        h = llama.last_hidden(h.to(ctx.home(0)), lengths)
        with _stage_scope(ctx, 0):
            return llama._head(params, h, cfg, ctx.quant_kernel, ctx.tps[0])[:, 0, :], cache

    return prefill


def build_decode_step(cfg, ctx: PPContext, kv_kernel: Optional[bool] = None):
    """As JAX's: returns ``decode(params, cache, tokens [B], positions [B],
    window=None) -> (logits [B, V], cache)``, one token a slot (dead slots
    at position 0) through every stage in order, each writing its layers'
    rows and reading its caches (``decode_attention`` over int8 strips
    with ``kv_kernel``, the einsum attention over ``[:window]`` of bf16
    ones); the logits are on stage 0's home."""

    def decode(params: Params, cache: list, tokens: torch.Tensor, positions: torch.Tensor,
               window: Optional[int] = None):
        h = params["embed"][tokens[:, None]]
        stages = zip(split_stages(params["layers"], ctx.stages), split_stages(cache, ctx.stages))
        for s, (layers, caches) in enumerate(stages):
            dev = ctx.home(s)
            with _stage_scope(ctx, s):
                h = llama.decode_stage(layers, cfg, h.to(dev), positions.to(dev), caches, window,
                                       ctx.quant_kernel, kv_kernel, ctx.tps[s])
        h = h.to(ctx.home(0))
        with _stage_scope(ctx, 0):
            return llama._head(params, h, cfg, ctx.quant_kernel, ctx.tps[0])[:, 0, :], cache

    return decode
