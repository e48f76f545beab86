"""Weight quantization for serving: int8 storage with per-channel scales.

Counterpart of generativeaiexamples_tpu/ops/quant.py. The packed layout is
the JAX package's, so packs cross packages unchanged:

    {"q": int8 [K_pad, F_pad], "scale": float32 [1, F]}

K padded to ``K_ALIGN``, F to ``F_BLK`` (zero padding); the scale keeps
the logical F. The fused single-device layout packs Q|K|V as ``wqkv`` and
gate|up as ``w_gateup`` (per-channel scales are unaffected by the
concatenation), so a decode layer runs four int8 matmuls.

Tensor-parallel packs (``tp_shards`` > 1) pad PER SHARD instead of at the
global end, so cutting the pack into ``tp_shards`` equal pieces along the
sharded axis hands every shard a self-contained kernel tile
(parallel/sharding.py cuts them, parallel/tp_kernels.py runs the kernels
on them):

- ``kind="column"`` (wq/wk/wv/w_gate/w_up/lm_head, Megatron
  column-parallel, output axis sharded): F splits into ``tp_shards``
  blocks, each padded to ``F_BLK``: q ``[K_pad, tp_shards * F_shard_pad]``;
  the scale keeps ``[1, F]``;
- ``kind="row"`` (wo/w_down, row-parallel, contraction axis sharded): K
  splits per shard, each padded to ``K_ALIGN``: q ``[tp_shards *
  K_shard_pad, F_pad]``.

Under TP the projections stay unfused (a fused output axis would hand a
shard a slab of Q features only), so a layer runs seven matmuls a shard.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.ops.int8_matmul import F_BLK, K_ALIGN

# Megatron kind per projection: column-parallel shards the output axis,
# row-parallel the contraction axis (parallel/sharding.py)
PACK_KINDS: Dict[str, str] = {
    "wq": "column",
    "wk": "column",
    "wv": "column",
    "w_gate": "column",
    "w_up": "column",
    "wqkv": "column",
    "w_gateup": "column",
    "lm_head": "column",
    "wo": "row",
    "w_down": "row",
}


def _pad_to(n: int, mult: int) -> int:
    return (n + mult - 1) // mult * mult


def _shard_blocks(K: int, F: int, tp_shards: int, kind: str):
    """(K_dst, F_dst, blocks): the padded destination and its copy blocks
    ``((dst_k0, dst_k1), (dst_f0, dst_f1), (src_k0, src_k1), (src_f0,
    src_f1))``, one a shard; ``tp_shards=1`` is one end-padded block. The
    one source of every packer's layout."""
    if tp_shards <= 1:
        return _pad_to(K, K_ALIGN), _pad_to(F, F_BLK), [((0, K), (0, F), (0, K), (0, F))]
    if kind == "column":
        if F % tp_shards:
            raise ValueError(f"column pack: F={F} not divisible by {tp_shards}")
        Fl = F // tp_shards
        Flp = _pad_to(Fl, F_BLK)
        blocks = [
            ((0, K), (i * Flp, i * Flp + Fl), (0, K), (i * Fl, (i + 1) * Fl))
            for i in range(tp_shards)
        ]
        return _pad_to(K, K_ALIGN), tp_shards * Flp, blocks
    if kind == "row":
        if K % tp_shards:
            raise ValueError(f"row pack: K={K} not divisible by {tp_shards}")
        Kl = K // tp_shards
        Klp = _pad_to(Kl, K_ALIGN)
        blocks = [
            ((i * Klp, i * Klp + Kl), (0, F), (i * Kl, (i + 1) * Kl), (0, F))
            for i in range(tp_shards)
        ]
        return tp_shards * Klp, _pad_to(F, F_BLK), blocks
    raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")


def _layout(q: torch.Tensor, tp_shards: int = 1, kind: str = "column") -> torch.Tensor:
    """Zero-pad an unpadded int8 ``[..., K, F]`` matrix into the (per-shard
    for ``tp_shards`` > 1) kernel layout."""
    K, F = q.shape[-2], q.shape[-1]
    K_dst, F_dst, blocks = _shard_blocks(K, F, tp_shards, kind)
    out = torch.zeros((*q.shape[:-2], K_dst, F_dst), dtype=torch.int8, device=q.device)
    for (dk, df, sk, sf) in blocks:
        out[..., dk[0]:dk[1], df[0]:df[1]] = q[..., sk[0]:sk[1], sf[0]:sf[1]]
    return out


def quantize_int8(w: torch.Tensor, tp_shards: int = 1, kind: str = "column") -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 packing of [..., K, F] weights
    (f32 math, round half to even: bit-equal to the JAX package). The
    divisor 127 is a tensor on ``w``'s device: CUDA turns a division by a
    host scalar into a product with its reciprocal, which rounds
    otherwise."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax / torch.full((), 127.0, device=w.device), min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": _layout(q, tp_shards, kind), "scale": scale}


def _unpad(q: torch.Tensor, K: int, F: int, tp_shards: int, kind: str) -> torch.Tensor:
    """The logical ``[..., K, F]`` integers of a pack: the inverse of
    :func:`_layout`."""
    if tp_shards <= 1:
        return q[..., :K, :F]
    _, _, blocks = _shard_blocks(K, F, tp_shards, kind)
    axis = -1 if kind == "column" else -2
    return torch.cat(
        [q[..., dk[0]:dk[1], df[0]:df[1]] for (dk, df, _, _) in blocks], dim=axis
    )


def dequantize_int8(
    packed: Dict[str, torch.Tensor],
    dtype=torch.bfloat16,
    k_features: int | None = None,
    tp_shards: int = 1,
    kind: str = "column",
) -> torch.Tensor:
    """Reconstruct weights. F padding is always cut (the logical F lives in
    the scale); K padding only when ``k_features`` is given. A
    tensor-parallel pack must be read with the ``tp_shards``/``kind`` it
    was built with (per-shard padding sits between the shards' blocks); a
    row pack then needs ``k_features``."""
    q = packed["q"]
    F = packed["scale"].shape[-1]
    if tp_shards > 1:
        if kind == "row" and k_features is None:
            raise ValueError("row-parallel dequant needs k_features")
        if kind not in ("column", "row"):
            raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")
        K = k_features if k_features is not None else q.shape[-2]
        q = _unpad(q, K, F, tp_shards, kind)
    else:
        q = q[..., : (k_features or q.shape[-2]), :F]
    return (q.float() * packed["scale"].float()).to(dtype)


def repack_int8(
    packed: Dict[str, torch.Tensor], k_features: int, tp_shards: int, kind: str,
    columns: slice = slice(None),
) -> Dict[str, torch.Tensor]:
    """A single-device pack's output ``columns`` (all by default) laid out
    again for ``tp_shards`` shards of ``kind``: the same integers and
    scales, so the pack computes the same function. How a fused ``wqkv``
    or ``w_gateup`` becomes the unfused per-shard packs of a TP tree."""
    F = packed["scale"].shape[-1]
    f0, f1, _ = columns.indices(F)
    q = packed["q"][..., :k_features, f0:f1]
    return {
        "q": _layout(q, tp_shards, kind),
        "scale": packed["scale"][..., f0:f1].clone(),
    }


def _quantize_int8_host(w, tp_shards: int = 1, kind: str = "column") -> Dict[str, torch.Tensor]:
    """Streaming numpy quantization of host-staged weights: one leading
    slice at a time in f32 (flat memory), bit-equal to quantize_int8."""
    arr = np.asarray(w)
    lead = arr.shape[:-2]
    K, F = arr.shape[-2], arr.shape[-1]
    K_dst, F_dst, blocks = _shard_blocks(K, F, tp_shards, kind)
    flat = arr.reshape((-1, K, F))
    q = np.zeros((flat.shape[0], K_dst, F_dst), np.int8)
    scale = np.zeros((flat.shape[0], 1, F), np.float32)
    for i in range(flat.shape[0]):
        w32 = flat[i].astype(np.float32)
        s = np.maximum(np.abs(w32).max(axis=0, keepdims=True) / np.float32(127.0), np.float32(1e-8))
        qi = np.clip(np.round(w32 / s), -127, 127).astype(np.int8)
        for (dk, df, sk, sf) in blocks:
            q[i, dk[0]:dk[1], df[0]:df[1]] = qi[sk[0]:sk[1], sf[0]:sf[1]]
        scale[i] = s
    return {
        "q": torch.from_numpy(q.reshape(*lead, K_dst, F_dst)),
        "scale": torch.from_numpy(scale.reshape(*lead, 1, F)),
    }


def quantize_params_int8(params: Dict[str, Any], tp_shards: int = 1) -> Dict[str, Any]:
    """Pack the projection matrices of a dense layered parameter dict as
    int8; embeddings and norms stay as they are. One shard fuses Q|K|V as
    ``wqkv`` and gate|up as ``w_gateup``; ``tp_shards`` > 1 keeps every
    projection unfused in the per-shard layout of its ``PACK_KINDS``
    kind, as the JAX function does."""
    fuse = tp_shards <= 1
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        if fuse and all(k in lp and not isinstance(lp[k], dict) for k in ("wq", "wk", "wv")):
            lp["wqkv"] = quantize_int8(
                torch.cat([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")], dim=-1)
            )
        if fuse and all(k in lp and not isinstance(lp[k], dict) for k in ("w_gate", "w_up")):
            lp["w_gateup"] = quantize_int8(torch.cat([lp.pop("w_gate"), lp.pop("w_up")], dim=-1))
        for key in ("wq", "wk", "wv", "w_gate", "w_up", "wo", "w_down"):
            if key in lp and not isinstance(lp[key], dict):
                lp[key] = quantize_int8(lp[key], tp_shards, PACK_KINDS[key])
        layers.append(lp)
    out["layers"] = layers
    if "lm_head" in out and not isinstance(out["lm_head"], dict):
        out["lm_head"] = quantize_int8(out["lm_head"], tp_shards, "column")
    return out


def fused_widths(cfg) -> Dict[str, Sequence[tuple]]:
    """The unfused projections inside each fused pack, as (name, width)
    in column order."""
    return {
        "wqkv": (("wq", cfg.q_dim), ("wk", cfg.kv_dim), ("wv", cfg.kv_dim)),
        "w_gateup": (("w_gate", cfg.intermediate_size), ("w_up", cfg.intermediate_size)),
    }


def _k_features(cfg) -> Dict[str, int]:
    """Each projection's logical contraction width."""
    h = cfg.hidden_size
    return {"wq": h, "wk": h, "wv": h, "w_gate": h, "w_up": h,
            "wo": cfg.q_dim, "w_down": cfg.intermediate_size, "lm_head": h}


def repack_layer_int8(lp: Dict[str, Any], cfg, tp_shards: int) -> Dict[str, Any]:
    """One layer of a single-device packed tree (fused or not) in the
    ``tp_shards`` layout: fused packs split into their projections, every
    pack laid out per shard, other leaves as they are."""
    k_of, widths = _k_features(cfg), fused_widths(cfg)
    new = {}
    for key, val in lp.items():
        if not isinstance(val, dict):
            new[key] = val
        elif key in widths:
            f0 = 0
            for name, width in widths[key]:
                new[name] = repack_int8(val, k_of[name], tp_shards, "column", slice(f0, f0 + width))
                f0 += width
        else:
            new[key] = repack_int8(val, k_of[key], tp_shards, PACK_KINDS[key])
    return new


def repack_params_int8(params: Dict[str, Any], cfg, tp_shards: int) -> Dict[str, Any]:
    """A single-device packed tree in the layout of
    ``quantize_params_int8(..., tp_shards)``. Integers and scales are
    unchanged, so both trees compute the same function."""
    out = dict(params)
    out["layers"] = [repack_layer_int8(lp, cfg, tp_shards) for lp in params["layers"]]
    if isinstance(out.get("lm_head"), dict):
        out["lm_head"] = repack_int8(out["lm_head"], cfg.hidden_size, tp_shards, "column")
    return out


def init_packed_params_int8(cfg, seed: int = 0, dtype=torch.bfloat16, device="cpu", tp_shards: int = 1):
    """Random parameters drawn directly in packed int8 form on ``device``
    from a seeded generator (uniform int8 in [-127, 127], std ~73, with
    scales chosen so the dequantized std matches ``init_spec``). Drawing
    on the device keeps the 8B weights out of host memory. Same structure
    as ``quantize_params_int8(init_params(cfg), tp_shards)``; ``dtype``
    applies to the embedding and the norms. Any ``tp_shards`` draws the
    single-device tree first and lays it out again, so one seed gives one
    function at every shard count."""
    from generativeaiexamples_tpu_torch.models.llama import init_spec

    gen = torch.Generator(device=device).manual_seed(seed)
    spec = init_spec(cfg)
    h = cfg.hidden_size

    def packed(*names):
        shapes = [spec[n][0][-2:] for n in names]
        K = shapes[0][0]
        F = sum(s[1] for s in shapes)
        q = torch.zeros((_pad_to(K, K_ALIGN), _pad_to(F, F_BLK)), dtype=torch.int8, device=device)
        q[:K, :F].random_(-127, 128, generator=gen)
        scale = torch.cat([
            torch.full((1, s[1]), spec[n][1] / 73.0, dtype=torch.float32, device=device)
            for n, s in zip(names, shapes)
        ], dim=-1)
        return {"q": q, "scale": scale}

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": torch.ones(h, dtype=dtype, device=device),
            "mlp_norm": torch.ones(h, dtype=dtype, device=device),
            "wqkv": packed("wq", "wk", "wv"),
            "w_gateup": packed("w_gate", "w_up"),
            "wo": packed("wo"),
            "w_down": packed("w_down"),
        })
    shape, std = spec["embed"]
    embed = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    params = {
        "embed": (embed.mul_(std)).to(dtype),
        "layers": layers,
        "final_norm": torch.ones(h, dtype=dtype, device=device),
    }
    del embed
    if "lm_head" in spec:
        params["lm_head"] = packed("lm_head")
    if tp_shards > 1:
        params = repack_params_int8(params, cfg, tp_shards)
    return params
