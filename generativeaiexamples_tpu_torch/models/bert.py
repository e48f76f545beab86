"""BERT-family text encoder (snowflake-arctic-embed-l architecture) in PyTorch.

Counterpart of generativeaiexamples_tpu/models/bert.py, as functions over a
parameter dict: the top-level tensors plus ``"layers"``, one dict of
tensors per layer (``models/convert.bert_params_from_numpy`` carries the
JAX tree, stacked on a leading layer axis, into this layout).

arctic-embed-l = BERT-large: 24 layers, hidden 1024, 16 heads, GELU FFN
4096, learned positions, post-LN; query and passage embeddings are the
L2-normalized CLS vector (model card).

The arithmetic follows the JAX function step by step, so that the two
agree on the same weights: the three embeddings summed in the parameter
dtype in JAX's order; ``layer_norm`` normalizes in f32, casts back, then
applies scale and bias in the parameter dtype; attention scores are
products of the parameter dtype summed in f32 (``_scores``), with the
-1e30 mask bias; the probabilities are cast to the parameter dtype before
P·V; exact GELU in f32. The module turns no process-wide switch: TF32
stays off (search scores and the f32 path need full f32), and cuBLAS
keeps PyTorch's default for bf16 GEMMs
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
chip_smoke.py holds the card's bf16 embeddings against the CPU's f32 ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    max_positions: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    pooling: str = "cls"  # arctic-embed uses CLS; "mean" supported too


BERT_PRESETS: Dict[str, BertConfig] = {
    "arctic-embed-l": BertConfig(),
    "arctic-embed-m": BertConfig(hidden_size=768, intermediate_size=3072, num_layers=12, num_heads=12),
    "debug": BertConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        max_positions=128,
    ),
}

# the weights drawn from N(0, 0.02); every other tensor starts at 0 or 1
_NORMAL = ("tok_embed", "pos_embed", "type_embed", "wq", "wk", "wv", "wo", "w_in", "w_out")


def param_shapes(cfg: BertConfig) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(top-level shapes, one layer's shapes), in JAX's names."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    top = {
        "tok_embed": (cfg.vocab_size, h),
        "pos_embed": (cfg.max_positions, h),
        "type_embed": (cfg.type_vocab_size, h),
        "embed_norm_scale": (h,),
        "embed_norm_bias": (h,),
    }
    layer = {
        "wq": (h, h), "bq": (h,), "wk": (h, h), "bk": (h,), "wv": (h, h), "bv": (h,),
        "wo": (h, h), "bo": (h,), "attn_norm_scale": (h,), "attn_norm_bias": (h,),
        "w_in": (h, f), "b_in": (f,), "w_out": (f, h), "b_out": (h,),
        "mlp_norm_scale": (h,), "mlp_norm_bias": (h,),
    }
    return top, layer


def matmul_params(cfg: BertConfig) -> int:
    """Parameters of the encoder's matmuls (each layer's six weight
    matrices): ~2 FLOPs each per token."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_layers * (4 * h * h + 2 * h * f)


def init_bert_params(cfg: BertConfig, generator: torch.Generator, dtype=torch.bfloat16,
                     device=None) -> Params:
    """Random weights from ``generator`` (drawn on its device), N(0, 0.02)
    as in JAX, norm scales 1, biases 0; on ``device`` (default: the
    generator's). The values differ from JAX's threefry draws: parity tests
    carry the JAX tree across with ``convert.bert_params_from_numpy``."""
    gen_dev = generator.device
    device = torch.device(device) if device is not None else gen_dev

    def make(name, shape):
        if name in _NORMAL:
            w = torch.randn(shape, generator=generator, device=gen_dev, dtype=torch.float32) * 0.02
            return w.to(dtype).to(device)
        fill = 1.0 if name.endswith("_scale") else 0.0
        return torch.full(shape, fill, dtype=dtype, device=device)

    top, layer = param_shapes(cfg)
    params: Params = {name: make(name, shape) for name, shape in top.items()}
    params["layers"] = [
        {name: make(name, shape) for name, shape in layer.items()} for _ in range(cfg.num_layers)
    ]
    return params


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize in f32, cast to x's dtype, then scale and shift in that
    dtype (JAX's order; ``F.layer_norm``'s affine would run in f32)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale + bias


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [N, T, D] · k [N, S, D]ᵀ summed in f32 (JAX's
    ``preferred_element_type=float32``). A product of two bf16 values is
    exact in f32, so both routes sum the same products: on the card one
    bf16 GEMM with an f32 output (``torch.bmm(..., out_dtype=float32)``),
    on the CPU (which lacks that overload) the operands widened first."""
    kt = k.transpose(1, 2)
    if q.dtype == torch.float32:
        return torch.bmm(q, kt)
    if q.is_cuda:
        return torch.bmm(q, kt, out_dtype=torch.float32)
    return torch.bmm(q.float(), kt.float())


def _layer(h: torch.Tensor, lp: Params, cfg: BertConfig, mask_bias: torch.Tensor) -> torch.Tensor:
    B, T, H = h.shape
    nh = cfg.num_heads
    Dh = H // nh
    scale = 1.0 / math.sqrt(Dh)

    def heads(x):  # [B, T, H] -> [B * nh, T, Dh]
        return x.reshape(B, T, nh, Dh).transpose(1, 2).reshape(B * nh, T, Dh)

    q = heads(h @ lp["wq"] + lp["bq"])
    k = heads(h @ lp["wk"] + lp["bk"])
    v = heads(h @ lp["wv"] + lp["bv"])
    scores = _scores(q, k).reshape(B, nh, T, T) * scale + mask_bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype).reshape(B * nh, T, T)
    attn = torch.bmm(probs, v).reshape(B, nh, T, Dh).transpose(1, 2).reshape(B, T, H)
    h = layer_norm(h + attn @ lp["wo"] + lp["bo"], lp["attn_norm_scale"], lp["attn_norm_bias"],
                   cfg.norm_eps)
    inner = torch.nn.functional.gelu((h @ lp["w_in"] + lp["b_in"]).float(), approximate="none")
    return layer_norm(h + inner.to(h.dtype) @ lp["w_out"] + lp["b_out"], lp["mlp_norm_scale"],
                      lp["mlp_norm_bias"], cfg.norm_eps)


def bert_encode(
    params: Params,
    cfg: BertConfig,
    token_ids: torch.Tensor,  # [B, T] int
    attention_mask: torch.Tensor,  # [B, T] 1 = real token
    token_type_ids: Optional[torch.Tensor] = None,  # [B, T] segment ids (cross-encoding)
    normalize: bool = True,
) -> torch.Tensor:
    """Encode a batch; returns pooled embeddings [B, H] (float32),
    L2-normalized unless ``normalize=False`` (cross-encoder head input)."""
    B, T = token_ids.shape
    ids = token_ids.long()
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(ids)
    h = params["tok_embed"][ids] + params["pos_embed"][:T][None, :, :] + params["type_embed"][
        token_type_ids.long()]
    h = layer_norm(h, params["embed_norm_scale"], params["embed_norm_bias"], cfg.norm_eps)
    mask_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e30).to(torch.float32)
    for lp in params["layers"]:
        h = _layer(h, lp, cfg, mask_bias)
    if cfg.pooling == "cls":
        pooled = h[:, 0, :]
    else:
        mask = attention_mask[..., None].to(h.dtype)
        pooled = (h * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)
    pooled = pooled.float()
    if not normalize:
        return pooled
    return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True).clamp_min(1e-12)


def init_rank_head(cfg: BertConfig, generator: torch.Generator, dtype=torch.bfloat16,
                   device=None) -> Params:
    """Cross-encoder relevance head: pooled CLS -> scalar logit."""
    device = torch.device(device) if device is not None else generator.device
    w = torch.randn((cfg.hidden_size, 1), generator=generator, device=generator.device,
                    dtype=torch.float32) * 0.02
    return {"w": w.to(dtype).to(device), "b": torch.zeros((1,), dtype=dtype, device=device)}


def cross_encode_score(
    params: Params,
    head: Params,
    cfg: BertConfig,
    token_ids: torch.Tensor,  # [B, T] "[CLS] query [SEP] passage [SEP]"
    attention_mask: torch.Tensor,  # [B, T]
    token_type_ids: torch.Tensor,  # [B, T] 0 = query segment, 1 = passage segment
) -> torch.Tensor:
    """Relevance logits [B] for query/passage pairs."""
    pooled = bert_encode(params, cfg, token_ids, attention_mask, token_type_ids, normalize=False)
    return (pooled @ head["w"].float() + head["b"].float())[:, 0]


_BERT_LAYER_KEYS = {
    "attention.self.query.weight": ("wq", True),
    "attention.self.query.bias": ("bq", False),
    "attention.self.key.weight": ("wk", True),
    "attention.self.key.bias": ("bk", False),
    "attention.self.value.weight": ("wv", True),
    "attention.self.value.bias": ("bv", False),
    "attention.output.dense.weight": ("wo", True),
    "attention.output.dense.bias": ("bo", False),
    "attention.output.LayerNorm.weight": ("attn_norm_scale", False),
    "attention.output.LayerNorm.bias": ("attn_norm_bias", False),
    "intermediate.dense.weight": ("w_in", True),
    "intermediate.dense.bias": ("b_in", False),
    "output.dense.weight": ("w_out", True),
    "output.dense.bias": ("b_out", False),
    "output.LayerNorm.weight": ("mlp_norm_scale", False),
    "output.LayerNorm.bias": ("mlp_norm_bias", False),
}
_BERT_TOP_KEYS = {
    "embeddings.word_embeddings.weight": "tok_embed",
    "embeddings.position_embeddings.weight": "pos_embed",
    "embeddings.token_type_embeddings.weight": "type_embed",
    "embeddings.LayerNorm.weight": "embed_norm_scale",
    "embeddings.LayerNorm.bias": "embed_norm_bias",
}


def load_bert_params(path: str, cfg: BertConfig, dtype=torch.bfloat16, device="cpu") -> Params:
    """HF BERT safetensors (``bert.encoder.layer.N.*`` naming, the
    ``bert.`` prefix optional) into this layout, in ``dtype`` on
    ``device``: Linear weights transposed to ``[in, out]``, JAX's key map.
    As JAX's, a layer key is kept only where every layer has it."""
    from generativeaiexamples_tpu_torch.models.hf_loader import _open_shards, _to

    L = cfg.num_layers
    layers: Dict[str, list] = {v[0]: [None] * L for v in _BERT_LAYER_KEYS.values()}
    params: Params = {}
    for name, tensor in _open_shards(path):
        stripped = name[len("bert."):] if name.startswith("bert.") else name
        if stripped in _BERT_TOP_KEYS:
            params[_BERT_TOP_KEYS[stripped]] = _to(tensor, device, dtype)
        elif stripped.startswith("encoder.layer."):
            rest = stripped[len("encoder.layer."):]
            idx_str, _, suffix = rest.partition(".")
            if suffix in _BERT_LAYER_KEYS:
                ours, transpose = _BERT_LAYER_KEYS[suffix]
                layers[ours][int(idx_str)] = _to(tensor.T if transpose else tensor, device, dtype)
    kept = [k for k, v in layers.items() if all(t is not None for t in v)]
    params["layers"] = [{k: layers[k][i] for k in kept} for i in range(L)]
    return params


def hf_tensors(params: Params) -> Dict[str, torch.Tensor]:
    """This layout's tensors under HF BERT names (``bert.`` prefix, Linear
    weights ``[out, in]``): the inverse of :func:`load_bert_params`, for
    writing a checkpoint (utils/safetensors_io.save_file)."""
    out = {f"bert.{hf}": params[ours] for hf, ours in _BERT_TOP_KEYS.items()}
    for i, lp in enumerate(params["layers"]):
        for hf, (ours, transpose) in _BERT_LAYER_KEYS.items():
            t = lp[ours]
            out[f"bert.encoder.layer.{i}.{hf}"] = t.T.contiguous() if transpose else t
    return out
