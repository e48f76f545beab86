"""Load HuggingFace Llama checkpoints (safetensors) into the port's tree.

Counterpart of generativeaiexamples_tpu/models/hf_loader.py, reading the
files with the port's own reader (utils/safetensors_io.py).

HF layout → the port's (one dict a layer, as models/llama.py serves it):
- ``model.embed_tokens.weight``            → ``embed``                [V, D]
- ``model.layers.{i}.input_layernorm``     → ``layers[i]["attn_norm"]``
- ``model.layers.{i}.self_attn.{q,k,v,o}_proj.weight`` (stored [out, in])
                                            → ``layers[i]["w{q,k,v,o}"]`` [in, out]
- ``model.layers.{i}.post_attention_layernorm`` → ``layers[i]["mlp_norm"]``
- ``model.layers.{i}.mlp.{gate,up,down}_proj``  → ``layers[i]["w_{gate,up,down}"]``
- ``model.norm.weight``                    → ``final_norm``
- ``lm_head.weight``                       → ``lm_head``              [D, V]

``load_params_layered_streaming`` is the serving engine's load: each
layer is transposed, quantized (int8 and w8a8: fused ``wqkv``/``w_gateup``
packs on one device, unfused per-shard packs under tensor parallelism)
and placed the moment its tensors complete, on the target device, so the
host holds about one layer's views of the mapped files at a time;
``load_params_pp_streaming`` does the same into the pipeline-parallel
layout (each layer on its stage's devices, parallel/pp_serving.py). The
packs are ``ops/quant.quantize_int8``'s, computed on the target device;
they equal the JAX package's host packs byte for byte.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, Iterator, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.models.llama import LlamaConfig, Params
from generativeaiexamples_tpu_torch.utils import safetensors_io

logger = logging.getLogger(__name__)


def config_from_hf(path: str) -> Optional[LlamaConfig]:
    """Build a LlamaConfig from a HF config.json if present."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    hidden = raw["hidden_size"]
    heads = raw["num_attention_heads"]
    return LlamaConfig(
        vocab_size=raw["vocab_size"],
        hidden_size=hidden,
        intermediate_size=raw["intermediate_size"],
        num_layers=raw["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=raw.get("num_key_value_heads", heads),
        head_dim=raw.get("head_dim", hidden // heads),
        rope_theta=raw.get("rope_theta", 500_000.0),
        norm_eps=raw.get("rms_norm_eps", 1e-5),
        max_seq_len=raw.get("max_position_embeddings", 8192),
        tie_embeddings=raw.get("tie_word_embeddings", False),
    )


def _open_shards(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor viewing the mapped file) across all
    safetensors shards, file by file in name order."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
    )
    if not files:
        raise FileNotFoundError(f"No .safetensors files under {path}")
    for fname in files:
        yield from safetensors_io.iter_tensors(fname)


_LAYER_KEYS = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down",
)

_HF_TO_OURS = {
    "input_layernorm.weight": ("attn_norm", False),
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "post_attention_layernorm.weight": ("mlp_norm", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def iter_param_groups(path: str, cfg: LlamaConfig, stats: Optional[dict] = None):
    """Stream a safetensors checkpoint as bounded-memory param groups.

    Yields ``("embed"|"final_norm"|"lm_head", tensor)`` as the top-level
    tensors appear and ``(layer_idx, {key: tensor})`` the moment a
    layer's 9 tensors are all present; projections (and ``lm_head``) come
    as transposed views ``[in, out]`` of the file's ``[out, in]``. The
    caller processes (quantizes, places) each group and drops it.

    ``stats`` (optional dict) receives ``peak_host_bytes``: the high-water
    mark of buffered tensor bytes (yielded-but-unconsumed excluded), the
    JAX function's accounting.
    """
    L = cfg.num_layers
    partial: Dict[int, Dict[str, torch.Tensor]] = {}
    done_layers = set()
    live = 0
    peak = 0

    def _track() -> None:
        nonlocal peak
        peak = max(peak, live)
        if stats is not None:
            stats["peak_host_bytes"] = peak

    for name, tensor in _open_shards(path):
        live += _nbytes(tensor)
        _track()
        if name == "model.embed_tokens.weight":
            yield "embed", tensor
        elif name == "model.norm.weight":
            yield "final_norm", tensor
        elif name == "lm_head.weight":
            yield "lm_head", tensor.T
        elif name.startswith("model.layers."):
            rest = name[len("model.layers."):]
            idx_str, _, suffix = rest.partition(".")
            ours = _HF_TO_OURS.get(suffix)
            if ours is None:
                logger.warning("Skipping unknown tensor %s", name)
                live -= _nbytes(tensor)
                continue
            key, transpose = ours
            idx = int(idx_str)
            partial.setdefault(idx, {})[key] = tensor.T if transpose else tensor
            if set(partial[idx]) == set(_LAYER_KEYS):
                group = partial.pop(idx)
                done_layers.add(idx)
                yield idx, group
                live -= sum(_nbytes(t) for t in group.values())
            continue  # layer tensors are released when the group completes
        else:
            logger.warning("Skipping unknown tensor %s", name)
        live -= _nbytes(tensor)

    missing = sorted(set(range(L)) - done_layers)
    if missing or partial:
        incomplete = {i: sorted(set(_LAYER_KEYS) - set(g)) for i, g in partial.items()}
        raise ValueError(
            f"Checkpoint incomplete: layers missing entirely {missing}, "
            f"partially loaded {incomplete}"
        )


def _to(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``. A transposed view of the
    mapped file crosses in its file order and is transposed there, so the
    host never stages a second copy."""
    if t.dim() == 2 and not t.is_contiguous() and t.T.is_contiguous():
        return t.T.to(device=device, dtype=dtype, copy=True).T.contiguous()
    return t.to(device=device, dtype=dtype, copy=True)


def load_params(path: str, cfg: LlamaConfig, dtype=torch.bfloat16, device="cpu") -> Params:
    """The dense parameter tree (one dict a layer) from a HF safetensors
    directory, every leaf in ``dtype`` on ``device``."""
    L = cfg.num_layers
    layers = [dict() for _ in range(L)]
    top: Dict[str, torch.Tensor] = {}

    for name, tensor in _open_shards(path):
        if name == "model.embed_tokens.weight":
            top["embed"] = _to(tensor, device, dtype)
        elif name == "model.norm.weight":
            top["final_norm"] = _to(tensor, device, dtype)
        elif name == "lm_head.weight":
            top["lm_head"] = _to(tensor.T, device, dtype)
        elif name.startswith("model.layers."):
            rest = name[len("model.layers."):]
            idx_str, _, suffix = rest.partition(".")
            ours = _HF_TO_OURS.get(suffix)
            if ours is None:
                logger.warning("Skipping unknown tensor %s", name)
                continue
            key, transpose = ours
            layers[int(idx_str)][key] = _to(tensor.T if transpose else tensor, device, dtype)
        else:
            logger.warning("Skipping unknown tensor %s", name)

    for key in _LAYER_KEYS:
        missing = [i for i, lp in enumerate(layers) if key not in lp]
        if missing:
            raise ValueError(f"Checkpoint missing layers {missing} for {key}")

    params: Params = {
        "embed": top["embed"],
        "layers": [{key: lp[key] for key in _LAYER_KEYS} for lp in layers],
        "final_norm": top["final_norm"],
    }
    if "lm_head" in top:
        params["lm_head"] = top["lm_head"]
    elif not cfg.tie_embeddings:
        logger.warning("No lm_head in checkpoint; tying to embeddings.")
    return params


def load_params_layered_streaming(
    path: str,
    cfg: LlamaConfig,
    dtype=torch.bfloat16,
    *,
    quantization: str = "none",
    mesh=None,
    tp_shards: int = 1,
    stats: Optional[dict] = None,
    device="cpu",
) -> Params:
    """Stream a checkpoint straight into the serving layout.

    Each layer is transposed to contiguous ``[in, out]`` on the target
    device (the first device of ``mesh``, else ``device``), quantized
    there (``quantization`` int8 or w8a8: fused ``wqkv``/``w_gateup``
    packs at ``tp_shards=1``, unfused per-shard packs of each
    projection's Megatron kind under TP, ops/quant.py) and, on a mesh of
    more than one shard, cut into its shards (parallel/sharding.py), the
    moment its tensors complete; the host views are then dropped.
    ``stats`` receives ``peak_host_bytes`` (``iter_param_groups``)."""
    from generativeaiexamples_tpu_torch.parallel import sharding

    sharded = mesh is not None and mesh.size > 1
    home = torch.device(mesh.home if mesh is not None else device)
    return _load_streaming(
        path, cfg, dtype, quantization, tp_shards, stats, home, lambda i: home,
        lambda i, lp: sharding.shard_layer(lp, mesh) if sharded else lp,
        lambda leaf: sharding.shard_params({"lm_head": leaf}, mesh)["lm_head"] if sharded else leaf,
        "",
    )


def load_params_pp_streaming(
    path: str,
    cfg: LlamaConfig,
    dtype=torch.bfloat16,
    *,
    quantization: str = "none",
    ctx,
    stats: Optional[dict] = None,
) -> Params:
    """Stream a checkpoint straight into the PP x TP layout of
    parallel/pp_serving.py: each layer is transposed, quantized (int8 or
    w8a8: per-shard packs of the stage's ``tp``, fused at ``tp`` 1) on its
    stage's first device and cut over the stage's shards the moment its
    tensors complete, so no device or host ever holds more than a layer
    beyond what it keeps. The tree is byte-equal to ``pp_serving.
    stage_params`` of the layered load's; ``stats`` receives
    ``peak_host_bytes``."""
    from generativeaiexamples_tpu_torch.parallel import pp_serving

    per = cfg.num_layers // ctx.stages
    return _load_streaming(
        path, cfg, dtype, quantization, ctx.tp, stats, ctx.home(0), lambda i: ctx.home(i // per),
        lambda i, lp: pp_serving.stage_layer(lp, ctx, i // per),
        lambda leaf: pp_serving.stage_head(leaf, ctx),
        f" into PP x TP ({ctx.stages} x {ctx.tp})",
    )


def _load_streaming(path, cfg, dtype, quantization, tp_shards, stats, home, layer_home,
                    place_layer, place_head, what) -> Params:
    """The streamed load: ``embed`` and ``final_norm`` to ``home``, the
    head quantized there and placed by ``place_head``, layer ``i`` built on
    ``layer_home(i)`` and placed by ``place_layer(i, lp)``."""
    from generativeaiexamples_tpu_torch.ops import quant

    q8 = quantization in ("int8", "w8a8")

    def pack(w, kind):
        return quant.quantize_int8(w, tp_shards, kind)

    layers: list = [None] * cfg.num_layers
    out: Params = {}
    stream_stats: dict = stats if stats is not None else {}
    for key, group in iter_param_groups(path, cfg, stats=stream_stats):
        if key in ("embed", "final_norm"):
            out[key] = _to(group, home, dtype)
        elif key == "lm_head":
            out["lm_head"] = place_head(pack(_to(group, home), "column") if q8
                                        else _to(group, home, dtype))
        else:  # (layer_idx, {key: tensor})
            device = layer_home(key)
            if q8:
                w = {k: _to(v, device) for k, v in group.items() if k not in ("attn_norm", "mlp_norm")}
                lp: Dict[str, object] = {
                    "attn_norm": _to(group["attn_norm"], device, dtype),
                    "mlp_norm": _to(group["mlp_norm"], device, dtype),
                    "wo": pack(w.pop("wo"), "row"),
                    "w_down": pack(w.pop("w_down"), "row"),
                }
                if tp_shards <= 1:
                    lp["wqkv"] = pack(torch.cat([w.pop("wq"), w.pop("wk"), w.pop("wv")], dim=-1), "column")
                    lp["w_gateup"] = pack(torch.cat([w.pop("w_gate"), w.pop("w_up")], dim=-1), "column")
                else:  # unfused under TP: shards align with heads
                    for name in ("wq", "wk", "wv", "w_gate", "w_up"):
                        lp[name] = pack(w.pop(name), quant.PACK_KINDS[name])
            else:
                lp = {k: _to(v, device, dtype) for k, v in group.items()}
            layers[key] = place_layer(key, lp)
            del lp, group  # the host views go; the device holds the layer
    out["layers"] = layers
    if "lm_head" not in out and not cfg.tie_embeddings:
        logger.warning("No lm_head in checkpoint; tying to embeddings.")
    logger.info(
        "Streamed checkpoint %s%s: %d layers%s, peak host %.2f GB",
        path,
        what,
        cfg.num_layers,
        ", int8 quantize-on-load" if q8 else "",
        stream_stats.get("peak_host_bytes", 0) / 1e9,
    )
    return out


def write_hf_checkpoint(
    cfg: LlamaConfig, path: str, seed: int = 0, n_shards: int = 2,
    dtype=torch.float32, device="cpu",
) -> None:
    """Write a random-weight HF-layout safetensors checkpoint (+config.json).

    The JAX function's layout, scales and sharding of layers over
    ``n_shards`` files; the draws come from a seeded ``torch.Generator``
    on ``device`` (the card draws an 8B-width file in seconds), each
    tensor ``N(0, 1) / sqrt(fan_in)`` in f32, then stored as ``dtype``
    (f32 as JAX's files; bf16 as real Llama-3 files)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, q, kv, f = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size

    def w(fan_in, shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.div_(math.sqrt(fan_in)).to(dtype)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    os.makedirs(path, exist_ok=True)
    shards = [[] for _ in range(n_shards)]
    for i in range(cfg.num_layers):
        shards[i * n_shards // cfg.num_layers].append(i)
    for s, idx in enumerate(shards):
        tensors: Dict[str, torch.Tensor] = {}
        if s == 0:
            tensors["model.embed_tokens.weight"] = w(h, (cfg.vocab_size, h))
            tensors["model.norm.weight"] = ones(h)
            if not cfg.tie_embeddings:
                tensors["lm_head.weight"] = w(h, (cfg.vocab_size, h))
        for i in idx:
            p = f"model.layers.{i}."
            tensors.update({
                p + "input_layernorm.weight": ones(h),
                p + "self_attn.q_proj.weight": w(h, (q, h)),
                p + "self_attn.k_proj.weight": w(h, (kv, h)),
                p + "self_attn.v_proj.weight": w(h, (kv, h)),
                p + "self_attn.o_proj.weight": w(q, (h, q)),
                p + "post_attention_layernorm.weight": ones(h),
                p + "mlp.gate_proj.weight": w(h, (f, h)),
                p + "mlp.up_proj.weight": w(h, (f, h)),
                p + "mlp.down_proj.weight": w(f, (h, f)),
            })
        safetensors_io.save_file(
            tensors, os.path.join(path, f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors")
        )
        del tensors
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as fh:
        json.dump(
            {
                "vocab_size": cfg.vocab_size,
                "hidden_size": cfg.hidden_size,
                "intermediate_size": cfg.intermediate_size,
                "num_hidden_layers": cfg.num_layers,
                "num_attention_heads": cfg.num_heads,
                "num_key_value_heads": cfg.num_kv_heads,
                "head_dim": cfg.head_dim,
                "rope_theta": cfg.rope_theta,
                "rms_norm_eps": cfg.norm_eps,
                "max_position_embeddings": cfg.max_seq_len,
                "tie_word_embeddings": cfg.tie_embeddings,
            },
            fh,
        )
