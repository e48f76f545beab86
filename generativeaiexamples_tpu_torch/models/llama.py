"""Llama-family decoder for the serving path, in PyTorch.

Counterpart of generativeaiexamples_tpu/models/llama.py, for the layered
serving path on both KV layouts. Paged: ``prefill_layers`` +
``write_prefill_pages`` for monolithic prefill waves,
``extend_layers_paged`` for chunked prefill, and ``decode_layers_paged``
for decode steps. Fixed (one dense strip per slot,
``init_kv_cache_layers``, which also builds the prefix cache's store):
``write_prefill_slots``, ``extend_layers``, ``decode_layers`` (int8 caches
read through ops/decode_attention.py), and ``copy_kv_rows`` between the
store and the slots. ``prefill_stage`` and ``decode_stage`` are the layer
loops of ``prefill_layers`` and ``decode_layers`` over any slice of the
layers, which is how a pipeline stage runs its own
(parallel/pp_serving.py). Speculative decoding: ``verify_layers_paged`` (the
K+1-row verify chunk through the page kernel), ``verify_layers`` and
the resident draft's ``draft_propose_layers`` (fixed layout). Training
and the merge checks: ``forward``, JAX's cache-free path (plain causal
attention, LoRA adapters through ``_proj``/``_lora_delta``, per-layer
rematerialization under ``remat``). Parameters are plain
dictionaries of tensors, one dict per layer (the JAX package's layered
layout, ``consume_split_params_layers``); projections are dense
``[K, F]`` matrices or int8 packs ``{"q", "scale"}`` (ops/quant.py), the
packs served weight-only or W8A8 (``quant_kernel``). The KV page pool is
bf16/f32, int8 or int4 (``init_kv_pool``); quantized pools store rows
through ``quantize_kv`` / ``quantize_kv_int4`` (bitwise the JAX codecs)
and are read through the page kernel or the dequantized gather, as in
JAX.

Differences from the JAX functions, all in PyTorch idiom:
- the KV page pool and the fixed caches are updated IN PLACE
  (``index_put_``): the dicts a caller passes are the ones returned, with
  no copy;
- the kernels are chosen by the same flags (``use_flash``,
  ``quant_kernel``, ``page_kernel``); a flag that selects a kernel runs
  it on CUDA tensors and its plain version on CPU tensors;
- random weights come from a seeded ``torch.Generator`` on the target
  device;
- tensor parallelism (``tp``, a ``parallel/tp_kernels.TPContext``): a
  weight cut into ``Shards`` runs through ``packed_matmul_tp``, a layer's
  cache is a ``Shards`` of per-shard dicts of ``Hkv / N`` heads, written
  shard by shard and read through the ``*_tp`` kernel launchers or, off
  the kernels, gathered back on the first shard's device; everything
  else (activations, norms, the embedding) stays whole there.

Physical page 0 of the pool is the scratch page: dead rows and padding
writes land there, never on a page a live request owns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from generativeaiexamples_tpu_torch.ops import (
    decode_attention, flash_attention, int8_matmul, page_attention, quant,
)
from generativeaiexamples_tpu_torch.parallel import sharding, tp_kernels
from generativeaiexamples_tpu_torch.parallel.sharding import Shards

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture hyperparameters (Llama-3 defaults)."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# Named presets, copied from the JAX package (tests/test_torch_llama.py
# pins them equal); selected via EngineConfig.model_config_name. The
# tiny ones serve tests: "debug" for the CPU parity tests,
# "kernel-8dev" for the head_dim-128 geometry the kernels accept.
PRESETS: Dict[str, LlamaConfig] = {
    "llama3-8b": LlamaConfig(),
    "llama3-70b": LlamaConfig(
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
    ),
    "llama3-1b-proxy": LlamaConfig(
        hidden_size=2048,
        intermediate_size=5504,
        num_layers=16,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
    ),
    "llama3-70b-tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=256,
        intermediate_size=512,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=4,
        max_seq_len=128,
    ),
    "debug": LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=128,
    ),
    "debug-1k": LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=1024,
    ),
    "debug-draft": LlamaConfig(
        vocab_size=512,
        hidden_size=32,
        intermediate_size=64,
        num_layers=1,
        num_heads=2,
        num_kv_heads=1,
        head_dim=16,
        max_seq_len=128,
    ),
    "debug-8dev": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=8,
        num_kv_heads=8,
        head_dim=16,
        max_seq_len=128,
    ),
    "llama3-70b-shard8": LlamaConfig(
        vocab_size=16032,
        hidden_size=8192,
        intermediate_size=3584,
        num_layers=80,
        num_heads=8,
        num_kv_heads=1,
        head_dim=128,
        max_seq_len=8192,
    ),
    "kernel-8dev": LlamaConfig(
        vocab_size=512,
        hidden_size=256,
        intermediate_size=512,
        num_layers=2,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=256,
    ),
}


def init_spec(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Weight name -> (shape, std) for random init, stacked on a leading
    layer axis as in the JAX package (one source for every initializer).
    Norm weights (ones) are not listed."""
    h, q, kv, f, L = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size, cfg.num_layers
    inv_h = 1.0 / math.sqrt(h)
    spec = {
        "embed": ((cfg.vocab_size, h), inv_h),
        "wq": ((L, h, q), inv_h),
        "wk": ((L, h, kv), inv_h),
        "wv": ((L, h, kv), inv_h),
        "wo": ((L, q, h), 1.0 / math.sqrt(q) / math.sqrt(2 * L)),
        "w_gate": ((L, h, f), inv_h),
        "w_up": ((L, h, f), inv_h),
        "w_down": ((L, f, h), 1.0 / math.sqrt(f) / math.sqrt(2 * L)),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((h, cfg.vocab_size), inv_h)
    return spec


def count_logical_params(cfg: LlamaConfig) -> int:
    """Parameter count from the architecture alone (int8 packs pad K and
    F, so counting storage would over-count)."""
    n = sum(math.prod(shape) for shape, _ in init_spec(cfg).values())
    return n + cfg.num_layers * 2 * cfg.hidden_size + cfg.hidden_size


def serving_memory_bytes(
    cfg: LlamaConfig, batch: int, max_seq_len: int, weight_bytes: float = 1, kv_bytes: float = 2,
) -> Dict[str, int]:
    """Device bytes the serving engine needs: weights and KV cache (the
    JAX function's fit-planning arithmetic). ``kv_bytes`` is per element
    and may be fractional (int4); a quantized width (< 2) carries the f32
    scale planes."""
    weights = int(count_logical_params(cfg) * weight_bytes)
    kv = 2 * batch * max_seq_len * cfg.num_kv_heads * cfg.head_dim
    cache = int(kv * cfg.num_layers * kv_bytes)
    if kv_bytes < 2:
        cache += 2 * batch * max_seq_len * cfg.num_kv_heads * cfg.num_layers * 4
    return {"weights": weights, "kv_cache": cache, "total": weights + cache}


_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_params(
    cfg: LlamaConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16, device="cpu"
) -> Params:
    """Scaled-normal random weights drawn on ``device`` from a seeded
    generator, one dict per layer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = init_spec(cfg)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * std).to(dtype)

    h = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"attn_norm": torch.ones(h, dtype=dtype, device=device),
              "mlp_norm": torch.ones(h, dtype=dtype, device=device)}
        for name in _LAYER_WEIGHTS:
            shape, std = spec[name]
            lp[name] = normal(shape[1:], std)
        layers.append(lp)
    params: Params = {
        "embed": normal(*spec["embed"]),
        "layers": layers,
        "final_norm": torch.ones(h, dtype=dtype, device=device),
    }
    if "lm_head" in spec:
        params["lm_head"] = normal(*spec["lm_head"])
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Rotary embedding. x: [B, T, H, Dh], positions: [B, T] int."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].float() * freqs  # [B, T, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(
    q: torch.Tensor,  # [B, T, Hq, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    mask: torch.Tensor,  # [B, T, S] bool, True = attend
) -> torch.Tensor:
    """Grouped-query attention: f32 scores and softmax, probabilities
    rounded to v's dtype, f32 sum of the P.V product, one rounding."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) / math.sqrt(Dh)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(B, T, Hq, Dh)


def _proj(x: torch.Tensor, w, quant_kernel=None, name: str = "", tp=None,
          lora=None, lora_scale: float = 1.0) -> torch.Tensor:
    """x @ w for a dense [K, F] matrix or an int8 pack (ops/quant.py).
    ``quant_kernel`` picks the pack's product (``int8_matmul.packed_matmul``
    modes): None or True, the weight-only int8 kernel; False, its plain
    version at decode shapes; ``"w8a8"``, per-token int8 activations and
    the int8 x int8 kernel; ``"w8a8_plain"``, that kernel's plain
    version. A weight cut into :class:`Shards` (parallel/sharding.py)
    runs on each shard's tile through ``tp_kernels.packed_matmul_tp``, as
    the projection ``name``'s Megatron kind (``quant.PACK_KINDS``). With
    ``lora`` (a layer's adapters, models/lora.py) holding ``name``'s, the
    low-rank delta ``lora_scale * (x @ A) @ B`` is added, cast to the
    output's dtype, as in JAX's ``_proj``."""
    mode = {None: "int8", True: "int8", False: "int8_plain"}.get(quant_kernel, quant_kernel)
    if isinstance(w, Shards):
        out = tp_kernels.packed_matmul_tp(x, w, tp, quant.PACK_KINDS[name], mode)
    elif isinstance(w, dict):
        out = int8_matmul.packed_matmul(x, w, mode)
    else:
        out = x @ w
    if lora is not None and f"{name}_a" in lora:
        out = out + (lora_scale * _lora_product(x, lora[f"{name}_a"], lora[f"{name}_b"], tp)
                     ).to(out.dtype)
    return out


def _lora_product(x: torch.Tensor, a, b, tp=None) -> torch.Tensor:
    """``(x @ A) @ B``, each factor whole or cut by models/lora.py's
    ``lora_param_specs``: a row-parallel target's A is cut on its input
    axis, so the shards' ``x_i @ A_i`` are partial sums, reduced
    (``tp_kernels.reduce_sum``) before ``@ B``; a column-parallel target's
    B is cut on its output axis, the shards' columns concatenated."""
    if isinstance(a, Shards):
        xa = tp_kernels.reduce_sum(tp_kernels.map_shards(
            lambda al, xl: xl @ al, tp, a, tp_kernels.scatter(x, tp, -1)), tp)
    else:
        xa = x @ a
    if isinstance(b, Shards):
        return tp_kernels.gather(tp_kernels.map_shards(lambda bl, xl: xl @ bl, tp, b, xa), tp, -1)
    return xa @ b


def _lora_delta(x: torch.Tensor, lora, name: str, scale: float) -> Optional[torch.Tensor]:
    """The LoRA delta of a projection folded into a fused pack (``wqkv``,
    ``w_gateup``), in ``x``'s dtype; None without adapters for ``name``."""
    if lora is None or f"{name}_a" not in lora:
        return None
    return (scale * ((x @ lora[f"{name}_a"]) @ lora[f"{name}_b"])).to(x.dtype)


def _block(h, lp, cfg: LlamaConfig, positions, attn, quant_kernel=None, tp=None,
           lora=None, lora_scale: float = 1.0):
    """One transformer block; ``attn(q, k, v) -> out`` supplies the
    attention flavor (einsum, flash kernel, or a paged read). Under
    ``tp`` the projections are unfused and run shard by shard; q, k and v
    come back whole (replicated), their heads the shards' in order.
    ``lora`` carries this layer's adapters (fine-tuning; serving merges
    them instead), applied on a fused pack's output slices too."""
    q, k, v = _qkv(h, lp, cfg, positions, quant_kernel, tp, lora, lora_scale)
    return _block_out(h, attn(q, k, v), lp, cfg, quant_kernel, tp, lora, lora_scale)


def _qkv(h, lp, cfg: LlamaConfig, positions, quant_kernel=None, tp=None, lora=None,
         lora_scale: float = 1.0):
    """A block's attention inputs: q ``[B, T, Hq, Dh]`` and k
    ``[B, T, Hkv, Dh]`` roped, v ``[B, T, Hkv, Dh]``."""
    B, T = h.shape[:2]
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    if "wqkv" in lp:  # int8-fused serving layout (ops/quant.py)
        qkv = _proj(x, lp["wqkv"], quant_kernel)
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
        dq, dk, dv = (_lora_delta(x, lora, n, lora_scale) for n in ("wq", "wk", "wv"))
        q = q if dq is None else q + dq
        k = k if dk is None else k + dk
        v = v if dv is None else v + dv
    else:
        q = _proj(x, lp["wq"], quant_kernel, "wq", tp, lora, lora_scale)
        k = _proj(x, lp["wk"], quant_kernel, "wk", tp, lora, lora_scale)
        v = _proj(x, lp["wv"], quant_kernel, "wv", tp, lora, lora_scale)
    q = apply_rope(q.reshape(B, T, cfg.num_heads, cfg.head_dim), positions, cfg)
    k = apply_rope(k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim), positions, cfg)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _block_out(h, attn_out, lp, cfg: LlamaConfig, quant_kernel=None, tp=None, lora=None,
               lora_scale: float = 1.0):
    """The rest of a block after its attention: ``wo``, the residual, the
    MLP and its residual."""
    B, T = h.shape[:2]
    h = h + _proj(attn_out.reshape(B, T, cfg.q_dim), lp["wo"], quant_kernel, "wo", tp,
                  lora, lora_scale)
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if "w_gateup" in lp:
        gate_raw, up = torch.split(
            _proj(x, lp["w_gateup"], quant_kernel), cfg.intermediate_size, dim=-1
        )
        dg, du = (_lora_delta(x, lora, n, lora_scale) for n in ("w_gate", "w_up"))
        gate_raw = gate_raw if dg is None else gate_raw + dg
        up = up if du is None else up + du
    else:
        gate_raw = _proj(x, lp["w_gate"], quant_kernel, "w_gate", tp, lora, lora_scale)
        up = _proj(x, lp["w_up"], quant_kernel, "w_up", tp, lora, lora_scale)
    gate = torch.nn.functional.silu(gate_raw.float()).to(x.dtype)
    return h + _proj(gate * up, lp["w_down"], quant_kernel, "w_down", tp, lora, lora_scale)


def _head(params: Params, h: torch.Tensor, cfg: LlamaConfig, quant_kernel=None, tp=None) -> torch.Tensor:
    """Final RMSNorm + (possibly tied) lm head; f32 logits."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return _proj(h, head, quant_kernel, "lm_head", tp).float()


def forward(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] int absolute positions
    remat: bool = False,
    lora: Optional[List[Dict[str, torch.Tensor]]] = None,
    lora_scale: float = 1.0,
    quant_kernel=None,
    tp=None,
) -> torch.Tensor:
    """The decoder without a cache (training, the merge checks): plain
    causal attention over the T tokens by position, f32 logits [B, T, V].
    JAX's cache-free ``forward`` path; ``lora`` is one adapter dict a
    layer (models/lora.py). Under ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` per layer):
    backward recomputes a layer's activations instead of keeping them.
    Under ``tp`` (a ``TPContext``) the weights and adapters cut into
    ``Shards`` run on their shards (``_proj``); the rest stays whole on
    the first shard's device. A sequence cut over a mesh's ``seq`` axis is
    :func:`forward_seq`."""
    return forward_seq([params], cfg, [tokens], [positions], remat,
                       None if lora is None else [lora], lora_scale, [tp], quant_kernel)[0]


class _RecomputeOnce(torch.autograd.Function):
    """Identity over a checkpointed layer's outputs, one autograd node for
    all of them, that saves a scalar. In the backward this node runs
    first of the segment's, and its unpack recomputes the segment, once,
    on one thread. A segment whose ops span cards (TP or seq shards on
    distinct cards) has nodes on several of autograd's device threads;
    without this node two of them reach the segment's saved tensors at
    once and each starts a recompute, which the non-reentrant checkpoint
    does not guard (it fails "Unexpected state: target_frame.early_stop
    is set")."""

    @staticmethod
    def forward(ctx, token, *outs):
        ctx.save_for_backward(token)
        return tuple(o.view_as(o) for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # the segment's first unpack: its recompute
        return (None, *grads)


def _spans_cards(tps, tokens) -> bool:
    """Whether a layer of :func:`forward_seq` runs on more than one
    device (its shards' and its seq shards')."""
    return len({str(d) for tp in tps if tp is not None for d in tp.devices}
               | {str(t.device) for t in tokens}) > 1


def forward_seq(
    params: List[Params],
    cfg: LlamaConfig,
    tokens: List[torch.Tensor],  # shard s's [B, T_s] ids
    positions: List[torch.Tensor],  # shard s's [B, T_s] absolute positions
    remat: bool = False,
    lora: Optional[List[List[Dict[str, torch.Tensor]]]] = None,
    lora_scale: float = 1.0,
    tps: Optional[List] = None,
    quant_kernel=None,
) -> List[torch.Tensor]:
    """:func:`forward` with the sequence cut over a mesh's ``seq`` shards:
    shard ``s`` holds its own rows of the sequence, its own copy of the
    weights (``params[s]``, ``lora[s]``, placed on its devices) and its
    ``TPContext`` (``tps[s]``, None for one device); returns each shard's
    f32 logits ``[B, T_s, V]`` on its first device.

    The shards run each layer in lockstep: every shard's q, k and v
    first, then each shard's attention over K and V gathered from the
    whole ring (``.to`` copies, which autograd differentiates) with the
    causal mask on global positions, through the same ``_attention`` as
    the one-device forward, so each row has the one-device arithmetic,
    the bf16 rounding of P included (an online-softmax ring would round
    otherwise). Under ``remat`` one layer of every shard is one
    checkpointed segment. One shard is :func:`forward`."""
    n = len(params)
    tps = tps if tps is not None else [None] * n
    spans_cards = _spans_cards(tps, tokens)
    hs = [p["embed"][t.long()] for p, t in zip(params, tokens)]
    masks = [pos[:, :, None] >= torch.cat([p.to(pos.device) for p in positions], 1)[:, None, :]
             for pos in positions]
    for i in range(len(params[0]["layers"])):
        los = [None if lora is None else lora[s][i] for s in range(n)]

        def layer(*hs, i=i, los=los):
            qkv = [_qkv(hs[s], params[s]["layers"][i], cfg, positions[s], quant_kernel, tps[s],
                        los[s], lora_scale) for s in range(n)]
            out = []
            for s in range(n):
                dev = hs[s].device
                k = torch.cat([qkv[r][1].to(dev) for r in range(n)], dim=1)
                v = torch.cat([qkv[r][2].to(dev) for r in range(n)], dim=1)
                attn_out = _attention(qkv[s][0], k, v, masks[s])
                out.append(_block_out(hs[s], attn_out, params[s]["layers"][i], cfg, quant_kernel,
                                      tps[s], los[s], lora_scale))
            if spans_cards and remat:
                return _RecomputeOnce.apply(torch.zeros((), device=out[0].device), *out)
            return tuple(out)

        if remat and torch.is_grad_enabled():
            hs = torch.utils.checkpoint.checkpoint(layer, *hs, use_reentrant=False)
        else:
            hs = layer(*hs)
    return [_head(params[s], hs[s], cfg, quant_kernel, tps[s]) for s in range(n)]


def count_params(params) -> int:
    """Elements of every tensor in a parameter tree (packs count their
    padded storage, as JAX's count over the leaves does)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return 0


# --------------------------------------------------------------------- #
# Sharded KV caches: under TP a layer's cache is a Shards of per-shard
# dicts (parallel/sharding.py), each holding that shard's KV heads on its
# device. Writes run shard by shard on the shard's heads; the non-kernel
# reads gather every shard's rows back on the first shard's device. Both
# go through tp_kernels' map_shards, scatter and gather.


def _first(c) -> Dict[str, torch.Tensor]:
    """A layer cache's (first shard's) dict."""
    return c[0] if isinstance(c, Shards) else c


def _write_heads(tp, fn, c, k, v, *args) -> None:
    """``fn(cache dict, k, v, *args)`` on a layer's cache: once, or under
    ``tp`` once a shard on that shard's heads of ``k`` and ``v``
    (``tp_kernels.map_shards``)."""
    if tp is None:
        fn(c, k, v, *args)
        return
    tp_kernels.map_shards(
        fn, tp, c, tp_kernels.scatter(k, tp, 2), tp_kernels.scatter(v, tp, 2), *args
    )


def _read_heads(tp, fn, c, *args) -> torch.Tensor:
    """``fn(cache dict, *args)`` on a layer's cache: once, or under ``tp``
    once a shard, the outputs concatenated on their head axis (2) on the
    first shard's device."""
    if tp is None:
        return fn(c, *args)
    return tp_kernels.gather(tp_kernels.map_shards(fn, tp, c, *args), tp, 2)


def _fields(c, key: str):
    """One leaf of a layer cache, as the TP kernels take it."""
    if key not in _first(c):
        return None
    return Shards(ci[key] for ci in c) if isinstance(c, Shards) else c[key]


def prefill_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] right-padded prompts
    lengths: torch.Tensor,  # [B]
    use_flash: Optional[bool] = None,
    quant_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Unrolled prefill; returns (last-token logits [B, V], per-layer
    (k, v) [B, T, Hkv, Dh] for the caller to write into the page pool).
    ``use_flash=None`` follows ``flash_attention.preferred``; with ``tp``
    the flash kernel runs head-sharded where ``flash_supported`` holds."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    h, kvs = prefill_stage(params["layers"], cfg, params["embed"][tokens], positions, use_flash,
                           quant_kernel, tp)
    return _head(params, last_hidden(h, lengths), cfg, quant_kernel, tp)[:, 0, :], kvs


def last_hidden(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's hidden state at its last prompt token, ``[B, 1, D]``."""
    return h[torch.arange(h.shape[0], device=h.device), lengths.long() - 1][:, None]


def prefill_stage(
    layers: List[Dict[str, Any]],
    cfg: LlamaConfig,
    h: torch.Tensor,  # [B, T, D] the embedded prompts, or an earlier stage's output
    positions: torch.Tensor,  # [B, T]
    use_flash: Optional[bool] = None,
    quant_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The monolithic prefill's layer loop over ``layers`` (a pipeline
    stage's slice, or every layer): returns (the hidden states ``[B, T,
    D]``, per-layer (k, v)). The prompt attends only itself, causally."""
    T = h.shape[1]
    if use_flash is None:
        use_flash = flash_attention.preferred(T, cfg.head_dim, h.device)
    if use_flash and tp is not None:
        use_flash = tp_kernels.flash_supported(cfg, tp.shards, T)
    mask = None if use_flash else positions[:, :, None] >= positions[:, None, :]
    kvs = []

    def attn(q, k, v):
        kvs.append((k, v))
        if use_flash and tp is not None:
            return tp_kernels.flash_attention_tp(q, k, v, tp)
        if use_flash:
            return flash_attention.flash_attention_causal(q, k, v)
        return _attention(q, k, v, mask)

    for lp in layers:
        h = _block(h, lp, cfg, positions, attn, quant_kernel, tp)
    return h, kvs


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) absmax int8 rows: [..., Dh] ->
    (int8 [..., Dh], f32 scale [...]); the W8A8 activation quantizer's
    formula (f32 math, round half to even), bitwise the JAX package's."""
    q, s = int8_matmul.quantize_rows(x)
    return q, s[..., 0]


def quantize_kv_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) absmax int4 rows, two per byte:
    [..., Dh] -> (uint8 [..., Dh//2], f32 scale [...]). Split halves: the
    low nibble of byte i holds lane i, the high nibble lane i + Dh/2.
    Values clip to [-7, 7]. Bitwise the JAX package's."""
    dh = x.shape[-1]
    if dh % 2:
        raise ValueError(f"int4 KV rows need an even head_dim, got {dh}")
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=-1) / 7.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / s[..., None]), -7, 7).to(torch.int32)
    lo = q[..., : dh // 2] & 0xF
    hi = q[..., dh // 2:] & 0xF
    return (lo | (hi << 4)).to(torch.uint8), s


# the inverse of quantize_kv_int4's packing, kept beside the page kernel
unpack_int4 = page_attention.unpack_int4


def _layers(cfg: LlamaConfig, one, cut, tp) -> list:
    """``one()`` a layer; under ``tp`` each layer cut on its KV heads
    (``cut``, parallel/sharding.py) as soon as it is made."""
    if tp is None:
        return [one() for _ in range(cfg.num_layers)]
    return [cut([one()], tp.mesh)[0] for _ in range(cfg.num_layers)]


def init_kv_pool(
    cfg: LlamaConfig, pool: int, page_size: int, dtype: torch.dtype = torch.bfloat16,
    device="cpu", quantized: bool = False, packed: bool = False, tp=None,
) -> list:
    """Per-layer page pools ``[pool, page_size, Hkv, Dh]``, token-major.
    ``quantized`` pools hold int8 rows with per-(token, head) f32 scales
    ``ks``/``vs`` ``[pool, page_size, Hkv]``; ``packed`` (int4) pools hold
    uint8 ``[pool, page_size, Hkv, Dh // 2]`` (two values per byte,
    :func:`quantize_kv_int4`) with the same scale planes. Readers tell the
    three apart by ``"ks" in pool`` and the uint8 dtype, as in JAX. Under
    ``tp`` each layer is a Shards of the shards' pools of ``Hkv / N``
    heads, each on its device (``sharding.shard_kv_pool``)."""
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim

    def one():
        if packed or quantized:
            if packed and Dh % 2:
                raise ValueError(f"int4 KV pools need an even head_dim, got {Dh}")
            shape = (pool, page_size, Hkv, Dh // 2 if packed else Dh)
            qdtype = torch.uint8 if packed else torch.int8
            return {
                "k": torch.zeros(shape, dtype=qdtype, device=device),
                "v": torch.zeros(shape, dtype=qdtype, device=device),
                "ks": torch.zeros(shape[:3], dtype=torch.float32, device=device),
                "vs": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            }
        shape = (pool, page_size, Hkv, Dh)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return _layers(cfg, one, sharding.shard_kv_pool, tp)


def _kv_codec(caches: list):
    """The pool's row quantizer (``quantize_kv``, ``quantize_kv_int4``)
    or None for a bf16/f32 pool."""
    c = _first(caches[0])
    if "ks" not in c:
        return None
    return quantize_kv_int4 if c["k"].dtype == torch.uint8 else quantize_kv


def _dequant_window(c, key: str, tables, pages_w: int, page_size: int) -> torch.Tensor:
    """A quantized pool's gathered window as f32 ``[N, W, Hkv, Dh]``:
    int4 bytes unpacked, integers times their row scales."""
    g = _gather_page_window(c[key], tables, pages_w, page_size)
    if g.dtype == torch.uint8:
        g = unpack_int4(g)
    s = _gather_page_window(c[key + "s"], tables, pages_w, page_size)
    return g.float() * s[..., None]


def _gather_page_window(
    buf: torch.Tensor, tables: torch.Tensor, pages_w: int, page_size: int
) -> torch.Tensor:
    """Each row's first ``pages_w`` pages as token rows: buf [P, page, ...]
    x tables [N, Pmax] -> [N, pages_w * page, ...]. Unused table entries
    point at the scratch page; callers mask their rows by position."""
    g = buf[tables[:, :pages_w].long()]
    return g.reshape((g.shape[0], pages_w * page_size) + tuple(buf.shape[2:]))


def write_prefill_pages(
    caches: list,
    kvs: list,  # per-layer (k, v) [N, T, Hkv, Dh] from prefill_layers
    row_tables: torch.Tensor,  # [N, Pmax] the wave rows' page tables
    page_size: int,
    tp=None,
) -> list:
    """Scatter a monolithic wave's fresh K/V rows into the page pool, in
    place (shard by shard under ``tp``). Right-padding rows land in the rows' own reserved pages (decode
    overwrites them before any query attends them) or, past the
    reservation, on the scratch page."""
    N, T = kvs[0][0].shape[:2]
    qfn = _kv_codec(caches)
    pos = torch.arange(T, device=row_tables.device)
    phys = torch.gather(row_tables.long(), 1, (pos // page_size).expand(N, T))
    sip = (pos % page_size).expand(N, T)

    def write(c, k, v, phys, sip):
        if qfn is not None:  # quantized rows: only the write is quantized
            kq, ks = qfn(k)
            vq, vs = qfn(v)
            c["ks"].index_put_((phys, sip), ks)
            c["vs"].index_put_((phys, sip), vs)
            k, v = kq, vq
        c["k"].index_put_((phys, sip), k.to(c["k"].dtype))  # in place
        c["v"].index_put_((phys, sip), v.to(c["v"].dtype))

    for c, (k, v) in zip(caches, kvs):
        _write_heads(tp, write, c, k, v, phys, sip)
    return caches


def _chunk_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, C]
    offsets: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N]
    slots: torch.Tensor,  # [N] page-table row per chunk row
    tables: torch.Tensor,  # [B, Pmax] page tables of all slots
    caches: list,
    window: int,
    page_size: int,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """A chunk of up to C tokens per row at each row's offset: rows write
    their valid tokens into their pages (in place; dead rows write the
    scratch page) and attend the gathered window of ``window`` tokens, or,
    with ``page_kernel``, read the pool through the paged-attention
    kernel (``paged_attention_tp`` under ``tp``)."""
    N, C = tokens.shape
    device = tokens.device
    qfn = _kv_codec(caches)
    Pmax = tables.shape[1]
    S = Pmax * page_size
    W = min(window, S)
    Pw = W // page_size
    ar = torch.arange(C, device=device)
    positions = torch.clamp(offsets.long()[:, None] + ar[None, :], max=S - 1)
    tok_valid = ar[None, :] < valid.long()[:, None]
    h = params["embed"][tokens]
    mask = torch.arange(W, device=device)[None, None, :] <= positions[:, :, None]
    row_tables = tables[slots.long()]
    phys = torch.gather(row_tables.long(), 1, positions // page_size)
    phys = torch.where((valid > 0)[:, None], phys, torch.zeros_like(phys))
    sip = positions % page_size

    def masked_write(buf, rows, trailing, phys, sip, tok_valid):
        """Write ``rows`` where the token is valid, the current contents
        elsewhere (a value mask over whole rows: an int4 byte never spans
        two tokens)."""
        cur = buf[phys, sip]
        keep = tok_valid.reshape(tok_valid.shape + (1,) * trailing)
        buf.index_put_((phys, sip), torch.where(keep, rows.to(cur.dtype), cur))  # in place

    def write(c, k, v, phys, sip, tok_valid):
        if qfn is not None:
            (kq, ks), (vq, vs) = qfn(k), qfn(v)
            masked_write(c["ks"], ks, 1, phys, sip, tok_valid)
            masked_write(c["vs"], vs, 1, phys, sip, tok_valid)
            k, v = kq, vq
        masked_write(c["k"], k, 2, phys, sip, tok_valid)
        masked_write(c["v"], v, 2, phys, sip, tok_valid)

    def window(c, key, row_tables, dtype):
        if qfn is not None:  # dequantized to the activation dtype (JAX's chunked formula)
            return _dequant_window(c, key, row_tables, Pw, page_size).to(dtype)
        return _gather_page_window(c[key], row_tables, Pw, page_size)

    for lp, c in zip(params["layers"], caches):
        def attn(q, k, v, c=c):
            _write_heads(tp, write, c, k, v, phys, sip, tok_valid)
            if page_kernel:
                return _paged_read(q, c, row_tables, offsets, tp)
            # a quantized pool reads as a bf16 one once dequantized
            return _attention(
                q, _read_heads(tp, window, c, "k", row_tables, q.dtype),
                _read_heads(tp, window, c, "v", row_tables, q.dtype), mask,
            )

        h = _block(h, lp, cfg, positions, attn, quant_kernel, tp)
    return h, caches


def _paged_read(q, c, tables, positions, tp) -> torch.Tensor:
    """The page kernel's read of a layer's pool, shard by shard under
    ``tp``."""
    if tp is not None:
        out = tp_kernels.paged_attention_tp(
            q, _fields(c, "k"), _fields(c, "v"), tables, positions,
            _fields(c, "ks"), _fields(c, "vs"), tp=tp,
        )
    else:
        out = page_attention.paged_attention(
            q, c["k"], c["v"], tables, positions, c.get("ks"), c.get("vs")
        )
    return out.to(q.dtype)


def extend_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    offsets: torch.Tensor,
    valid: torch.Tensor,
    slots: torch.Tensor,
    tables: torch.Tensor,
    caches: list,
    window: int,
    page_size: int,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """Chunked prefill over the page pool; returns (each row's hidden state
    at its last valid token [N, D], pools). The engine leaves
    ``page_kernel`` unset here, as the JAX engine does: prefill-chunk
    widths exceed the kernel's query-row cap."""
    C = tokens.shape[1]
    h, caches = _chunk_layers_paged(
        params, cfg, tokens, offsets, valid, slots, tables, caches, window,
        page_size, quant_kernel=quant_kernel, page_kernel=page_kernel, tp=tp,
    )
    last_idx = torch.clamp(valid.long(), 1, C) - 1
    return h[torch.arange(h.shape[0], device=h.device), last_idx], caches


def verify_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, C] last accepted token ++ K draft tokens
    offsets: torch.Tensor,  # [N] each row's chunk start (its decode position)
    valid: torch.Tensor,  # [N] real tokens in the chunk (0 = dead row)
    slots: torch.Tensor,  # [N] page-table row per chunk row
    tables: torch.Tensor,  # [B, Pmax]
    caches: list,
    window: int,
    page_size: int,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """Speculative-decoding verify over the page pool: the chunk pass of
    ``extend_layers_paged`` with logits at every chunk position, ``[N, C,
    V]``. Position j's logits are the next-token distribution after the
    prefix ending at ``offsets + j``. With ``page_kernel`` the K+1 query
    rows of each row read the pool through ``paged_attention``; the
    engine sets it where ``supports_geometry(query_len=K+1)`` accepts.
    Rejected draft rows stay in the pool above the accepted frontier,
    where the next verify chunk overwrites them before any query attends
    them."""
    h, caches = _chunk_layers_paged(
        params, cfg, tokens, offsets, valid, slots, tables, caches, window,
        page_size, quant_kernel=quant_kernel, page_kernel=page_kernel, tp=tp,
    )
    return _head(params, h, cfg, quant_kernel, tp), caches


def decode_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] (dead slots pre-zeroed by the engine)
    live: torch.Tensor,  # [B] bool
    tables: torch.Tensor,  # [B, Pmax]
    caches: list,
    window: Optional[int] = None,
    page_size: int = 128,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """One decode step over the page pool; returns (logits [B, V], pools).
    Each row writes its new K/V row in place (dead rows write the scratch
    page), then reads the pool through the paged-attention kernel
    (``page_kernel``; ``paged_attention_tp`` under ``tp``) or the gathered
    window of ``window`` tokens."""
    device = tokens.device
    qfn = _kv_codec(caches)
    B = tokens.shape[0]
    Hkv, G = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    Pmax = tables.shape[1]
    S = Pmax * page_size
    W = min(window or S, S)
    Pw = W // page_size
    h = params["embed"][tokens[:, None]]
    pos2 = positions.long()[:, None]  # [B, 1]
    phys = torch.gather(tables.long(), 1, pos2 // page_size)
    phys = torch.where(live[:, None], phys, torch.zeros_like(phys))
    sip = pos2 % page_size
    mask = torch.arange(W, device=device)[None, None, :] <= pos2[:, :, None]

    def write(c, k, v, phys, sip):
        if qfn is not None:
            (k, ks), (v, vs) = qfn(k), qfn(v)
            c["ks"].index_put_((phys, sip), ks)  # in place
            c["vs"].index_put_((phys, sip), vs)
        c["k"].index_put_((phys, sip), k.to(c["k"].dtype))  # in place
        c["v"].index_put_((phys, sip), v.to(c["v"].dtype))

    def dequant(c, key, tables):
        return _dequant_window(c, key, tables, Pw, page_size)

    def gathered(c, key, tables):
        return _gather_page_window(c[key], tables, Pw, page_size)

    for lp, c in zip(params["layers"], caches):
        def attn(q, k, v, c=c):
            _write_heads(tp, write, c, k, v, phys, sip)
            if page_kernel:
                return _paged_read(q, c, tables, positions, tp)
            if qfn is not None:
                # JAX's quantized decode read: the window dequantized to
                # f32, f32 einsums and softmax, one rounding at the end
                kd = _read_heads(tp, dequant, c, "k", tables)  # [B, W, Hkv, Dh]
                vd = _read_heads(tp, dequant, c, "v", tables)
                qg = q.reshape(B, 1, Hkv, G, cfg.head_dim).float()
                sc = torch.einsum("btkgd,bskd->bkgts", qg, kd) / math.sqrt(cfg.head_dim)
                sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, -1e30))
                p = torch.softmax(sc, dim=-1)
                out = torch.einsum("bkgts,bskd->btkgd", p, vd)
                return out.reshape(B, 1, cfg.num_heads, cfg.head_dim).to(q.dtype)
            return _attention(
                q, _read_heads(tp, gathered, c, "k", tables), _read_heads(tp, gathered, c, "v", tables),
                mask,
            )

        h = _block(h, lp, cfg, pos2, attn, quant_kernel, tp)
    return _head(params, h, cfg, quant_kernel, tp)[:, 0, :], caches


# --------------------------------------------------------------------- #
# Fixed KV layout (kv_layout='fixed'): one dense strip of S = max_seq_len
# rows per decode slot, per layer. bf16/f32 caches are token-major
# [B, S, Hkv, Dh]; int8 caches are head-major [B, Hkv, S, Dh] with scales
# [B, Hkv, 1, S], the geometry ops/decode_attention.py streams.


def init_kv_cache_layers(
    cfg: LlamaConfig,
    batch: int,
    max_seq_len: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quantized: bool = False,
    tp=None,
) -> list:
    """Per-layer fixed-layout caches: ``[B, S, Hkv, Dh]`` in ``dtype``, or
    for ``quantized`` head-major int8 ``[B, Hkv, S, Dh]`` with per-(slot,
    head, row) f32 scales ``ks``/``vs`` ``[B, Hkv, 1, S]``. Under ``tp``
    each layer is a Shards of the shards' caches of ``Hkv / N`` heads
    (``sharding.shard_kv_cache_layered``)."""
    S = max_seq_len or cfg.max_seq_len
    B, Hkv, Dh = batch, cfg.num_kv_heads, cfg.head_dim

    def one():
        if quantized:
            return {
                "k": torch.zeros((B, Hkv, S, Dh), dtype=torch.int8, device=device),
                "v": torch.zeros((B, Hkv, S, Dh), dtype=torch.int8, device=device),
                "ks": torch.zeros((B, Hkv, 1, S), dtype=torch.float32, device=device),
                "vs": torch.zeros((B, Hkv, 1, S), dtype=torch.float32, device=device),
            }
        return {"k": torch.zeros((B, S, Hkv, Dh), dtype=dtype, device=device),
                "v": torch.zeros((B, S, Hkv, Dh), dtype=dtype, device=device)}

    return _layers(cfg, one, sharding.shard_kv_cache_layered, tp)


def copy_kv_rows(src: list, dst: list, src_slot: int, dst_slot: int, length: int) -> None:
    """Copy rows ``[0, length)`` of slot ``src_slot`` of the fixed-layout
    caches ``src`` into slot ``dst_slot`` of ``dst``, in place, for every
    layer's k, v and (int8) scales: the prefix store's fetch (store ->
    slot) and insert (slot -> store). Device to device on the caller's
    stream; no host read. Sharded caches copy shard by shard."""
    for s, d in zip(src, dst):
        if isinstance(s, Shards):
            copy_kv_rows(list(s), list(d), src_slot, dst_slot, length)
            continue
        if "ks" in s:  # head-major [B, Hkv, S, Dh], scales [B, Hkv, 1, S]
            d["k"][dst_slot, :, :length].copy_(s["k"][src_slot, :, :length])
            d["v"][dst_slot, :, :length].copy_(s["v"][src_slot, :, :length])
            d["ks"][dst_slot, :, :, :length].copy_(s["ks"][src_slot, :, :, :length])
            d["vs"][dst_slot, :, :, :length].copy_(s["vs"][src_slot, :, :, :length])
        else:  # token-major [B, S, Hkv, Dh]
            d["k"][dst_slot, :length].copy_(s["k"][src_slot, :length])
            d["v"][dst_slot, :length].copy_(s["v"][src_slot, :length])


def _cache_len(caches: list) -> int:
    c = _first(caches[0])
    return c["k"].shape[2] if "ks" in c else c["k"].shape[1]


def write_prefill_slots(
    caches: list,
    kvs: list,  # per-layer (k, v) [N, T, Hkv, Dh] from prefill_layers
    slots: torch.Tensor,  # [N] the wave rows' slots
    tp=None,
) -> list:
    """Write a monolithic wave's fresh K/V rows at ``[slot, 0:T]`` of each
    slot's strip, in place (int8 caches quantize the rows on the write;
    shard by shard under ``tp``).
    Right-padding rows land past the prompt, where decode overwrites them
    before any query attends them."""
    T = kvs[0][0].shape[1]

    def write(c, k, v, s):
        if "ks" in c:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)  # [N, T, Hkv, Dh], [N, T, Hkv]
            c["k"][s, :, :T] = kq.transpose(1, 2)  # in place, head-major
            c["v"][s, :, :T] = vq.transpose(1, 2)
            c["ks"][s, :, 0, :T] = ks.transpose(1, 2)
            c["vs"][s, :, 0, :T] = vs.transpose(1, 2)
        else:
            c["k"][s, :T] = k.to(c["k"].dtype)  # in place
            c["v"][s, :T] = v.to(c["v"].dtype)

    for c, (k, v) in zip(caches, kvs):
        _write_heads(tp, write, c, k, v, slots.long())
    return caches


def _chunk_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, C]
    offsets: torch.Tensor,  # [N] absolute position of each row's chunk start
    valid: torch.Tensor,  # [N] real tokens in this chunk (0 = done row)
    slots: torch.Tensor,  # [N] target cache slots
    caches: list,
    window: int,
    quant_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """A chunk of up to C tokens per row at each row's offset over the fixed
    caches: the chunk's K/V rows are written at ``[slot, offset:offset+C]``
    in place, value-masked by ``valid`` (rows past ``valid`` write back
    what they read, so ``valid == 0`` rows and a final chunk's garbage tail
    change nothing; tail positions clamp to ``S - 1``), then every query
    attends the ``[:window]`` prefix of its slot's strip. int8 caches are
    read dequantized to f32 and cast to the activation dtype, as in JAX."""
    N, C = tokens.shape
    device = tokens.device
    first = _first(caches[0])
    quantized = "ks" in first
    S = _cache_len(caches)
    W = min(window, S)
    ar = torch.arange(C, device=device)
    positions = torch.clamp(offsets.long()[:, None] + ar[None, :], max=S - 1)  # [N, C]
    tok_valid = ar[None, :] < valid.long()[:, None]  # [N, C]
    h = params["embed"][tokens]
    mask = torch.arange(W, device=device)[None, None, :] <= positions[:, :, None]  # [N, C, W]
    s = slots.long()
    if quantized:
        s3 = s[:, None, None]  # [N, 1, 1]
        h3 = torch.arange(first["k"].shape[1], device=device)[None, :, None]  # [1, Hkv, 1] a shard
        p3 = positions[:, None, :]  # [N, 1, C]
        rows_idx = (s3, h3, p3)  # -> [N, Hkv, C, ...]
        scale_idx = (s3, h3, torch.zeros_like(p3), p3)
        keep_rows = tok_valid[:, None, :, None]
        keep_scales = tok_valid[:, None, :]
    else:
        rows_idx = (s[:, None], positions)  # -> [N, C, Hkv, Dh]
        keep_rows = tok_valid[:, :, None, None]

    def masked_write(buf, idx, rows, keep):
        cur = buf[idx]
        buf.index_put_(idx, torch.where(keep, rows.to(cur.dtype), cur))  # in place

    def write_int8(c, k, v, rows_idx, scale_idx, keep_rows, keep_scales):
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        masked_write(c["k"], rows_idx, kq.transpose(1, 2), keep_rows)
        masked_write(c["v"], rows_idx, vq.transpose(1, 2), keep_rows)
        masked_write(c["ks"], scale_idx, ks.transpose(1, 2), keep_scales)
        masked_write(c["vs"], scale_idx, vs.transpose(1, 2), keep_scales)

    def write(c, k, v, rows_idx, keep_rows):
        masked_write(c["k"], rows_idx, k, keep_rows)
        masked_write(c["v"], rows_idx, v, keep_rows)

    def read_int8(c, key, s, dtype):  # [N, W, Hkv, Dh] dequantized
        w = c[key][s, :, :W].float() * c[key + "s"][s, :, 0, :W][..., None]
        return w.transpose(1, 2).to(dtype)

    def read(c, key, s):
        return c[key][s, :W]

    for lp, c in zip(params["layers"], caches):
        def attn(q, k, v, c=c):
            if quantized:
                _write_heads(tp, write_int8, c, k, v, rows_idx, scale_idx, keep_rows, keep_scales)
                return _attention(
                    q, _read_heads(tp, read_int8, c, "k", s, q.dtype),
                    _read_heads(tp, read_int8, c, "v", s, q.dtype), mask,
                )
            _write_heads(tp, write, c, k, v, rows_idx, keep_rows)
            return _attention(q, _read_heads(tp, read, c, "k", s), _read_heads(tp, read, c, "v", s), mask)

        h = _block(h, lp, cfg, positions, attn, quant_kernel, tp)
    return h, caches


def extend_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, C] one prompt chunk per row
    offsets: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N]
    slots: torch.Tensor,  # [N]
    caches: list,
    window: int,  # power of two >= max(offsets) + C
    quant_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """Chunked prefill over the fixed caches; returns (each row's hidden
    state at its last valid token [N, D], caches)."""
    C = tokens.shape[1]
    h, caches = _chunk_layers(
        params, cfg, tokens, offsets, valid, slots, caches, window, quant_kernel=quant_kernel,
        tp=tp,
    )
    last_idx = torch.clamp(valid.long(), 1, C) - 1
    return h[torch.arange(h.shape[0], device=h.device), last_idx], caches


def verify_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, C] last accepted token ++ K draft tokens
    offsets: torch.Tensor,  # [N] absolute write position of each row's chunk
    valid: torch.Tensor,  # [N] real tokens in this chunk (0 = dead row)
    slots: torch.Tensor,  # [N] target cache slots
    caches: list,
    window: int,  # power of two >= max(offsets) + C
    quant_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """Speculative-decoding verify over the fixed caches: the chunk pass
    of ``extend_layers`` with logits at every chunk position, ``[N, C,
    V]``: what ``decode_layers`` would give one token at a time, in one
    dispatch. Writes are ``extend_layers``'s (positions past ``valid`` are
    value-masked), so rejected draft rows sit above the accepted frontier
    until the next chunk overwrites them. The attention is the plain
    chunk attention over the strip, as in JAX."""
    h, caches = _chunk_layers(
        params, cfg, tokens, offsets, valid, slots, caches, window, quant_kernel=quant_kernel,
        tp=tp,
    )
    return _head(params, h, cfg, quant_kernel, tp), caches


def draft_propose_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, C0] catch-up chunk (tokens past each row's frontier)
    offsets: torch.Tensor,  # [B] each row's draft-KV frontier
    valid: torch.Tensor,  # [B] catch-up tokens in the chunk (0 = dead row)
    caches: list,  # the draft model's fixed-layout caches, one strip per slot
    window: int,  # power of two covering frontier + C0 + draft_k
    draft_k: int,
    vocab: int,  # argmax bound: the target's sampling vocab
    quant_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """Resident-draft proposal for the whole decode wave: the catch-up
    chunk (the tokens the target emitted since each row's frontier, at
    most K + 1) as one ``_chunk_layers`` pass over the draft caches, whose
    last logits give draft token 1, then ``draft_k - 1`` greedy
    ``decode_layers`` steps (``kv_kernel=False``) writing speculative rows
    above the frontier. Writing the catch-up over the previous round's
    rejected rows is the acceptance rewind. Returns ``([B, draft_k]
    proposals, caches)``. Dead rows write nothing in the catch-up and park
    their steps at row 0 of their own strip; ``vocab`` bounds every argmax
    to tokens the target can emit. Under ``tp`` the draft's weights and
    caches are cut as the target's and every pass runs shard by shard."""
    B, C0 = tokens.shape
    device = tokens.device
    S = _cache_len(caches)
    slot_ids = torch.arange(B, device=device)
    h, caches = _chunk_layers(
        params, cfg, tokens, offsets, valid, slot_ids, caches, window, quant_kernel=quant_kernel,
        tp=tp,
    )
    valid = valid.long()
    last_h = h[slot_ids, torch.clamp(valid, 1, C0) - 1][:, None, :]
    logits = _head(params, last_h, cfg, quant_kernel, tp)[:, 0, :]
    live = valid > 0
    tok = torch.argmax(logits[:, :vocab], dim=-1)
    # the first draft token's row lands right past the caught-up frontier
    pos = torch.where(live, torch.clamp(offsets.long() + torch.clamp(valid, min=1), max=S - 1), 0)
    drafts = [tok]
    for _ in range(draft_k - 1):
        lg, caches = decode_layers(
            params, cfg, tok, pos, caches, window=window, quant_kernel=quant_kernel,
            kv_kernel=False, tp=tp,
        )
        tok = torch.argmax(lg[:, :vocab], dim=-1)
        drafts.append(tok)
        pos = torch.where(live, torch.clamp(pos + 1, max=S - 1), 0)
    return torch.stack(drafts, dim=1), caches


def decode_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] (dead slots pre-zeroed by the engine)
    caches: list,
    window: Optional[int] = None,
    quant_kernel: Optional[bool] = None,
    kv_kernel: Optional[bool] = None,
    tp=None,
) -> Tuple[torch.Tensor, list]:
    """One decode step over the fixed caches; returns (logits [B, V],
    caches). Each slot writes its new K/V row in place at its position (a
    dead slot at position 0 writes row 0 of its own strip), then reads: an
    int8 cache through ``decode_attention`` (``kv_kernel``;
    ``decode_attention_tp`` under ``tp``) or ``decode_attention_xla`` over
    the first ``window`` rows, a bf16/f32 cache through the einsum
    attention over ``[:window]``."""
    h = decode_stage(params["layers"], cfg, params["embed"][tokens[:, None]], positions, caches,
                     window, quant_kernel, kv_kernel, tp)
    return _head(params, h, cfg, quant_kernel, tp)[:, 0, :], caches


def decode_stage(
    layers: List[Dict[str, Any]],
    cfg: LlamaConfig,
    h: torch.Tensor,  # [B, 1, D]
    positions: torch.Tensor,  # [B]
    caches: list,  # one fixed-layout cache a layer of ``layers``
    window: Optional[int] = None,
    quant_kernel: Optional[bool] = None,
    kv_kernel: Optional[bool] = None,
    tp=None,
) -> torch.Tensor:
    """``decode_layers``' layer loop over ``layers`` and their caches (a
    pipeline stage's slice, or every layer); returns the hidden state
    ``[B, 1, D]``."""
    device = h.device
    B = h.shape[0]
    first = _first(caches[0])
    quantized = "ks" in first
    S = _cache_len(caches)
    W = min(window or S, S)
    pos2 = positions.long()[:, None]  # [B, 1]
    b_idx = torch.arange(B, device=device)[:, None]  # [B, 1]
    if quantized:
        b3, p3 = b_idx[:, :, None], pos2[:, :, None]  # [B, 1, 1]
        h3 = torch.arange(first["k"].shape[1], device=device)[None, None, :]  # [1, 1, Hkv] a shard
        z3 = torch.zeros_like(p3)
        pos32 = positions.to(torch.int32)  # the kernel's dtype, cast once for all layers
    else:
        mask = torch.arange(W, device=device)[None, None, :] <= pos2[:, :, None]  # [B, 1, W]

    def write_int8(c, k, v, rows, scales):
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)  # [B, 1, Hkv, Dh], [B, 1, Hkv]
        c["k"].index_put_(rows, kq)  # in place
        c["v"].index_put_(rows, vq)
        c["ks"].index_put_(scales, ks)
        c["vs"].index_put_(scales, vs)

    def write(c, k, v, rows):
        c["k"].index_put_(rows, k.to(c["k"].dtype))  # in place
        c["v"].index_put_(rows, v.to(c["v"].dtype))

    def read_int8(c, q, pos2):
        return decode_attention.decode_attention_xla(
            q, c["k"], c["ks"], c["v"], c["vs"], pos2, window=W
        )

    def read(c, key):
        return c[key][:, :W]

    for lp, c in zip(layers, caches):
        def attn(q, k, v, c=c):
            if quantized:
                _write_heads(tp, write_int8, c, k, v, (b3, h3, p3), (b3, h3, z3, p3))
                if kv_kernel and tp is not None:
                    out = tp_kernels.decode_attention_tp(
                        q[:, 0], _fields(c, "k"), _fields(c, "ks"), _fields(c, "v"),
                        _fields(c, "vs"), pos32, tp,
                    )
                    return out[:, None].to(q.dtype)
                if kv_kernel:
                    return decode_attention.decode_attention(
                        q[:, 0], c["k"], c["ks"], c["v"], c["vs"], pos32
                    )[:, None].to(q.dtype)
                q_heads = q if tp is None else tp_kernels.scatter(q, tp, 2)
                return _read_heads(tp, read_int8, c, q_heads, pos2)
            _write_heads(tp, write, c, k, v, (b_idx, pos2))
            return _attention(q, _read_heads(tp, read, c, "k"), _read_heads(tp, read, c, "v"), mask)

        h = _block(h, lp, cfg, pos2, attn, quant_kernel, tp)
    return h
