"""Weight quantization for serving: int8 storage with per-channel scales.

Counterpart of generativeaiexamples_tpu/ops/quant.py (single-device packs
only: ``tp_shards=1``). The packed layout is the JAX package's, so packs
cross packages unchanged:

    {"q": int8 [K_pad, F_pad], "scale": float32 [1, F]}

K padded to ``K_ALIGN``, F to ``F_BLK`` (zero padding); the scale keeps
the logical F. The fused serving layout packs Q|K|V as ``wqkv`` and
gate|up as ``w_gateup`` (per-channel scales are unaffected by the
concatenation), so a decode layer runs four int8 matmuls.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from generativeaiexamples_tpu_torch.ops.int8_matmul import F_BLK, K_ALIGN


def _pad_to(n: int, mult: int) -> int:
    return (n + mult - 1) // mult * mult


def _layout(q: torch.Tensor) -> torch.Tensor:
    """Zero-pad int8 [..., K, F] to the kernel layout [..., K_pad, F_pad]."""
    K, F = q.shape[-2], q.shape[-1]
    out = torch.zeros(
        (*q.shape[:-2], _pad_to(K, K_ALIGN), _pad_to(F, F_BLK)), dtype=torch.int8, device=q.device
    )
    out[..., :K, :F] = q
    return out


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 packing of [..., K, F] weights
    (f32 math, round half to even: bit-equal to the JAX package)."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": _layout(q), "scale": scale}


def dequantize_int8(
    packed: Dict[str, torch.Tensor], dtype=torch.bfloat16, k_features: int | None = None
) -> torch.Tensor:
    """Reconstruct weights. F padding is always cut (the logical F lives in
    the scale); K padding only when ``k_features`` is given."""
    q = packed["q"]
    F = packed["scale"].shape[-1]
    q = q[..., : (k_features or q.shape[-2]), :F]
    return (q.float() * packed["scale"].float()).to(dtype)


def _quantize_int8_host(w) -> Dict[str, torch.Tensor]:
    """Streaming numpy quantization of host-staged weights: one leading
    slice at a time in f32 (flat memory), bit-equal to quantize_int8."""
    arr = np.asarray(w)
    lead = arr.shape[:-2]
    K, F = arr.shape[-2], arr.shape[-1]
    flat = arr.reshape((-1, K, F))
    q = np.zeros((flat.shape[0], _pad_to(K, K_ALIGN), _pad_to(F, F_BLK)), np.int8)
    scale = np.zeros((flat.shape[0], 1, F), np.float32)
    for i in range(flat.shape[0]):
        w32 = flat[i].astype(np.float32)
        s = np.maximum(np.abs(w32).max(axis=0, keepdims=True) / np.float32(127.0), np.float32(1e-8))
        q[i, :K, :F] = np.clip(np.round(w32 / s), -127, 127).astype(np.int8)
        scale[i] = s
    return {
        "q": torch.from_numpy(q.reshape(*lead, *q.shape[1:])),
        "scale": torch.from_numpy(scale.reshape(*lead, 1, F)),
    }


def quantize_params_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Pack the projection matrices of a dense layered parameter dict as
    int8 (Q|K|V fused as ``wqkv``, gate|up as ``w_gateup``); embeddings
    and norms stay as they are."""
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        if all(k in lp for k in ("wq", "wk", "wv")):
            lp["wqkv"] = quantize_int8(
                torch.cat([lp.pop("wq"), lp.pop("wk"), lp.pop("wv")], dim=-1)
            )
        if all(k in lp for k in ("w_gate", "w_up")):
            lp["w_gateup"] = quantize_int8(torch.cat([lp.pop("w_gate"), lp.pop("w_up")], dim=-1))
        for key in ("wo", "w_down"):
            if key in lp and not isinstance(lp[key], dict):
                lp[key] = quantize_int8(lp[key])
        layers.append(lp)
    out["layers"] = layers
    if "lm_head" in out and not isinstance(out["lm_head"], dict):
        out["lm_head"] = quantize_int8(out["lm_head"])
    return out


def init_packed_params_int8(cfg, seed: int = 0, dtype=torch.bfloat16, device="cpu"):
    """Random parameters drawn directly in packed int8 form on ``device``
    from a seeded generator (uniform int8 in [-127, 127], std ~73, with
    scales chosen so the dequantized std matches ``init_spec``). Drawing
    on the device keeps the 8B weights out of host memory. Same structure
    as ``quantize_params_int8(init_params(cfg))``; ``dtype`` applies to
    the embedding and the norms."""
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
    return params
