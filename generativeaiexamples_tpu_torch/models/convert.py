"""Carry a JAX parameter tree into the port's parameter layout.

``params_from_jax(tree)`` takes the JAX package's Llama parameter pytree
with numpy arrays as leaves (``np.asarray`` of each leaf is enough), either
stacked on a leading layer axis (``init_params``,
``init_packed_params_int8``) or already split per layer
(``consume_split_params_layers``), dense or int8-packed, and returns the
port's layout: one dict of tensors per layer.

bfloat16 leaves (numpy's ml_dtypes type, which ``torch.from_numpy`` does
not accept) cross bit-exactly as a ``uint16`` view reinterpreted as
``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def to_tensor(arr, device="cpu") -> torch.Tensor:
    """One array leaf as a tensor, bit-exact (bfloat16 through uint16)."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _num_layers(stacked: Dict[str, Any]) -> int:
    for val in stacked.values():
        if isinstance(val, dict):
            return _num_layers(val)
        return np.asarray(val).shape[0]
    raise ValueError("empty layer tree")


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """The port's parameters from a JAX parameter tree (see module doc)."""
    layers = tree["layers"]
    if isinstance(layers, dict):  # stacked on a leading layer axis
        L = _num_layers(layers)
        layers = [
            _map(layers, lambda a, i=i: np.asarray(a)[i]) for i in range(L)
        ]
    out = {k: _map(v, lambda a: to_tensor(a, device)) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(lp, lambda a: to_tensor(a, device)) for lp in layers]
    return out
