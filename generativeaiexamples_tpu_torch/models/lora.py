"""LoRA adapters for the Llama decoder (fine-tuning plane).

Counterpart of generativeaiexamples_tpu/models/lora.py, in the port's
layered layout: the adapters are one dict a layer, ``{f"{t}_a": [in, r],
f"{t}_b": [r, out]}`` for each target ``t`` (the JAX tree stacks the same
tensors on a leading layer axis; ``convert.lora_from_jax`` carries it).

Convention: for a base weight W [in, out], A ~ N(0, 1/in), B = 0 (the
delta starts at 0), effective weight W + (alpha/r) · A·B; models/llama.py
applies the delta in ``_proj``. ``merge`` folds the adapters into a copy
of the base weights for serving, so the engine never pays the extra
matmul. Sharding the adapters (JAX's ``lora_param_specs``,
``shard_lora_params``) waits for sharded training (ROADMAP queue 1 item
15).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from generativeaiexamples_tpu_torch.models.llama import LlamaConfig, Params

# projection name -> (in_dim, out_dim) extractor
_TARGET_DIMS = {
    "wq": lambda c: (c.hidden_size, c.q_dim),
    "wk": lambda c: (c.hidden_size, c.kv_dim),
    "wv": lambda c: (c.hidden_size, c.kv_dim),
    "wo": lambda c: (c.q_dim, c.hidden_size),
    "w_gate": lambda c: (c.hidden_size, c.intermediate_size),
    "w_up": lambda c: (c.hidden_size, c.intermediate_size),
    "w_down": lambda c: (c.intermediate_size, c.hidden_size),
}

LoRAParams = List[Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def __post_init__(self) -> None:
        unknown = set(self.targets) - set(_TARGET_DIMS)
        if unknown:
            raise ValueError(f"Unknown LoRA targets: {sorted(unknown)}")


def init_lora_params(
    cfg: LlamaConfig, lora_cfg: LoRAConfig, generator: torch.Generator,
    dtype=torch.bfloat16, device=None,
) -> LoRAParams:
    """One adapter dict a layer: ``{f"{t}_a": [in, r], f"{t}_b": [r, out]}``,
    A drawn in f32 from ``generator`` (on its device) as N(0, 1/in) and cast
    to ``dtype``, B zero; every tensor on ``device`` (the generator's by
    default)."""
    device = torch.device(device) if device is not None else generator.device
    r = lora_cfg.rank
    layers: LoRAParams = [dict() for _ in range(cfg.num_layers)]
    for target in lora_cfg.targets:
        d_in, d_out = _TARGET_DIMS[target](cfg)
        for lp in layers:
            a = torch.randn((d_in, r), generator=generator, device=generator.device,
                            dtype=torch.float32) / math.sqrt(d_in)
            lp[f"{target}_a"] = a.to(device=device, dtype=dtype)
            lp[f"{target}_b"] = torch.zeros((r, d_out), dtype=dtype, device=device)
    return layers


def merge(params: Params, lora_params: LoRAParams, lora_cfg: LoRAConfig) -> Params:
    """Fold adapters into a copy of the base params: W += (alpha/r)·A·B,
    computed in f32 and cast back to W's dtype (the base is not touched;
    layers without targets share its tensors)."""
    layers = []
    for lp, lo in zip(params["layers"], lora_params):
        lp = dict(lp)
        for target in lora_cfg.targets:
            delta = (lo[f"{target}_a"].float() @ lo[f"{target}_b"].float()) * lora_cfg.scale
            lp[target] = (lp[target].float() + delta).to(lp[target].dtype)
        layers.append(lp)
    merged = dict(params)
    merged["layers"] = layers
    return merged


def count_lora_params(lora_params: LoRAParams) -> int:
    return sum(t.numel() for lp in lora_params for t in lp.values())
