"""LoRA adapters for the Llama decoder (fine-tuning plane).

Counterpart of generativeaiexamples_tpu/models/lora.py, in the port's
layered layout: the adapters are one dict a layer, ``{f"{t}_a": [in, r],
f"{t}_b": [r, out]}`` for each target ``t`` (the JAX tree stacks the same
tensors on a leading layer axis; ``convert.lora_from_jax`` carries it).

Convention: for a base weight W [in, out], A ~ N(0, 1/in), B = 0 (the
delta starts at 0), effective weight W + (alpha/r) · A·B; models/llama.py
applies the delta in ``_proj``. ``merge`` folds the adapters into a copy
of the base weights for serving, so the engine never pays the extra
matmul. On a mesh (``shard_lora_params``, JAX's ``lora_param_specs``):
a column-parallel target's B is cut on its output axis like the weight
it perturbs, a row-parallel target's (``wo``, ``w_down``) A on its input
axis, and the other factor stays whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.models.llama import LlamaConfig, Params, count_params
from generativeaiexamples_tpu_torch.parallel import sharding

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

# Column-parallel targets shard B's out dim on the model axis; row-parallel
# targets (wo, w_down) shard A's in dim instead (matching param_specs()).
_ROW_PARALLEL = {"wo", "w_down"}

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


def lora_param_specs(lora_cfg: LoRAConfig) -> Dict[str, Optional[int]]:
    """The axis each adapter of a layer is cut on over the ``model`` axis,
    from the end (-2 A's input axis, -1 B's output axis; None: whole on
    every shard), JAX's ``lora_param_specs`` without its layer axis."""
    specs: Dict[str, Optional[int]] = {}
    for target in lora_cfg.targets:
        row = target in _ROW_PARALLEL
        specs[f"{target}_a"] = -2 if row else None
        specs[f"{target}_b"] = None if row else -1
    return specs


def shard_lora_params(lora_params: LoRAParams, lora_cfg: LoRAConfig, mesh) -> LoRAParams:
    """The adapters cut by :func:`lora_param_specs` over the mesh's
    ``model`` sub-mesh (``sharding.model_mesh``): a cut leaf becomes a
    ``Shards``, a whole one goes to the sub-mesh's first device, where
    the replicated activations live; with one ``model`` shard every
    adapter stays whole there."""
    tp_mesh = sharding.model_mesh(mesh)
    specs = lora_param_specs(lora_cfg)

    def put(name, x):
        if tp_mesh.size == 1 or specs[name] is None:
            return x.to(tp_mesh.home)
        return sharding.cut(x, tp_mesh.size, specs[name], tp_mesh.devices)

    return [{name: put(name, x) for name, x in lp.items()} for lp in lora_params]


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
    """Elements of every adapter (a cut one's pieces together)."""
    return count_params(lora_params)
