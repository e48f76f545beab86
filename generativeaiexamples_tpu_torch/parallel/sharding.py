"""Megatron sharding of the Llama parameter tree and the KV caches.

Counterpart of generativeaiexamples_tpu/parallel/sharding.py. Where the
JAX package annotates each leaf with a ``PartitionSpec`` and lets the
compiler place the pieces, the port cuts each sharded leaf into a
:class:`Shards` list, piece ``i`` on the mesh's device ``i``; shard ``i``'s
own tree is the ``i``-th piece of every sharded leaf.

The axes (``param_specs``, ``layer_param_specs``, ``kv_pool_specs``,
``kv_cache_layer_specs``):

- column-parallel ``wq``/``wk``/``wv``/``w_gate``/``w_up``/``lm_head``: a
  dense matrix and an int8 pack's ``q`` split on the output axis, the
  pack's scale follows the output axis (``_int8_pack_specs``);
- row-parallel ``wo``/``w_down``: split on the contraction axis; a pack's
  scale (output axis only) is whole on every shard;
- page pools ``[P, page, Hkv, Dh]`` and their scales ``[P, page, Hkv]``
  split on ``Hkv``; fixed caches on their ``Hkv`` axis (2 token-major, 1
  head-major with its ``[B, Hkv, 1, S]`` scales);
- the embedding, the norms, page tables and positions are replicated:
  they stay whole on the first shard's device, where the replicated
  activations live (a row gather is exact, so no shard needs its own).

A pack is cut only from the per-shard layout of ops/quant.py
(``tp_shards`` equal to the mesh size), where each piece is a
self-contained kernel tile; ``shard_params(..., repack_cfg=cfg)`` first
lays a single-device tree out again (fused packs split), so one random
tree serves every shard count and computes one function.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.ops import quant
from generativeaiexamples_tpu_torch.parallel import multihost
from generativeaiexamples_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh


class Shards(list):
    """One piece a shard of a sharded leaf (a tensor, an int8 pack or a
    layer's cache dict), in shard order. ``dim`` is the axis a tensor was
    cut on (:func:`cut`; from the end where negative), which
    :func:`unshard` joins the pieces on."""

    dim: Optional[int] = None

    def like(self, pieces) -> "Shards":
        """``pieces`` as a Shards cut on this one's axis."""
        out = Shards(pieces)
        out.dim = self.dim
        return out


def param_specs() -> Dict[str, Any]:
    """The sharded axis of every parameter, from the end (-1 the output
    axis, -2 the contraction axis; None: replicated)."""
    return {"embed": None, "layers": layer_param_specs(), "final_norm": None, "lm_head": -1}


def layer_param_specs() -> Dict[str, Optional[int]]:
    """One layer's leaves: column-parallel on the output axis, row-parallel
    on the contraction axis, norms replicated."""
    return {"attn_norm": None, "mlp_norm": None, "wq": -1, "wk": -1, "wv": -1,
            "w_gate": -1, "w_up": -1, "wo": -2, "w_down": -2}


def _int8_pack_specs(axis: int) -> Dict[str, Optional[int]]:
    """A pack's ``q`` shards like the dense matrix; its per-output-channel
    scale follows the output axis only."""
    return {"q": axis, "scale": -1 if axis == -1 else None}


def cut(x: torch.Tensor, n: int, dim: int, devices) -> Shards:
    """``x`` split into ``n`` equal pieces along ``dim``, each contiguous on
    its device."""
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} not divisible by {n} shards")
    out = Shards(p.to(d).contiguous() for p, d in zip(torch.chunk(x, n, dim=dim), devices))
    out.dim = dim
    return out


def unshard(x, device):
    """A tree whose :class:`Shards` of tensors are joined whole on their
    cut axis, every tensor on ``device`` (the inverse of :func:`cut`)."""
    if isinstance(x, Shards):
        return torch.cat([unshard(p, device) for p in x], dim=x.dim)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: unshard(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [unshard(v, device) for v in x]
    return x


def activation_spec(seq_sharded: bool = False) -> Tuple[Optional[str], ...]:
    """The mesh axis each axis of ``[B, T, D]`` activations is cut on
    (JAX's ``PartitionSpec`` as a tuple): batch on ``data``, the sequence
    on ``seq`` under ``seq_sharded``."""
    return (DATA_AXIS, SEQ_AXIS if seq_sharded else None, None)


def token_spec(seq_sharded: bool = False) -> Tuple[Optional[str], ...]:
    """The same for ``[B, T]`` token ids and loss masks."""
    return (DATA_AXIS, SEQ_AXIS if seq_sharded else None)


def model_mesh(mesh: Mesh) -> Mesh:
    """The ``model`` sub-mesh a parameter tree is cut over: the mesh
    itself for a (``model``) mesh; on a training mesh with ``data`` or
    ``seq`` axes, the first sequence shard of this process's first data
    replica, where the train step keeps its state (models/train.py)."""
    if mesh.data == 1 and mesh.seq == 1 and mesh.processes == 1:
        return mesh
    return mesh.tp_mesh(mesh.process_replicas(multihost.process_index())[0], 0)


def _put(x, axis: Optional[int], mesh: Mesh):
    n, devs = mesh.size, mesh.devices
    if isinstance(x, dict):  # int8 pack {"q", "scale"}
        specs = _int8_pack_specs(axis)
        pieces = {
            k: cut(v, n, specs[k], devs) if specs[k] is not None
            else Shards(v.to(d) for d in devs)
            for k, v in x.items()
        }
        return Shards({k: pieces[k][i] for k in x} for i in range(n))
    return cut(x, n, axis, devs)


def shard_layer(lp: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """One layer's parameters in the mesh's per-shard layout, cut."""
    specs, out = layer_param_specs(), {}
    for key, val in lp.items():
        if key not in specs:  # wqkv, w_gateup
            raise ValueError(
                f"{key}: a fused pack does not shard on heads; lay the tree out "
                "per shard first (shard_params(..., repack_cfg=cfg))"
            )
        out[key] = val.to(mesh.home) if specs[key] is None else _put(val, specs[key], mesh)
    return out


def shard_params(params: Dict[str, Any], mesh: Mesh, repack_cfg=None) -> Dict[str, Any]:
    """The parameter tree with every sharded leaf cut into :class:`Shards`.
    ``params`` is in the mesh's per-shard layout (dense, or
    ``quant.quantize_params_int8(..., mesh.size)``); with ``repack_cfg``
    (the model config) it is a single-device tree, laid out again one
    layer at a time first (``quant.repack_params_int8``). On a training
    mesh the tree is cut over :func:`model_mesh` (whole on its one device
    where the ``model`` axis is 1)."""
    if mesh is not model_mesh(mesh):
        mesh = model_mesh(mesh)
        if mesh.size == 1:
            return unshard(params, mesh.home)
    repack = repack_cfg is not None and mesh.size > 1
    out = {}
    for key, val in params.items():
        if key == "layers":
            out["layers"] = [
                shard_layer(quant.repack_layer_int8(lp, repack_cfg, mesh.size) if repack else lp, mesh)
                for lp in val
            ]
        elif key == "lm_head":
            if repack and isinstance(val, dict):
                val = quant.repack_int8(val, repack_cfg.hidden_size, mesh.size, "column")
            out["lm_head"] = _put(val, param_specs()["lm_head"], mesh)
        else:
            out[key] = val.to(mesh.home)
    return out


def is_sharded(params: Dict[str, Any]) -> bool:
    """Whether a parameter tree holds :class:`Shards` leaves."""
    return any(isinstance(v, Shards) for v in params["layers"][0].values())


def kv_pool_specs(quantized: bool) -> Dict[str, int]:
    """One layer's page-pool leaves: the ``Hkv`` axis of ``[P, page, Hkv,
    Dh]`` pools and ``[P, page, Hkv]`` scales."""
    return {"k": 2, "v": 2, "ks": 2, "vs": 2} if quantized else {"k": 2, "v": 2}


def kv_cache_layer_specs(quantized: bool) -> Dict[str, int]:
    """One layer's fixed caches: bf16 ``[B, S, Hkv, Dh]``; int8 head-major
    ``[B, Hkv, S, Dh]`` with ``[B, Hkv, 1, S]`` scales."""
    return {"k": 1, "v": 1, "ks": 1, "vs": 1} if quantized else {"k": 2, "v": 2}


def _shard_layers(layers: List[Dict[str, torch.Tensor]], specs, mesh: Mesh) -> List[Shards]:
    out = []
    for layer in layers:
        pieces = {k: cut(v, mesh.size, specs[k], mesh.devices) for k, v in layer.items()}
        out.append(Shards({k: pieces[k][i] for k in layer} for i in range(mesh.size)))
    return out


def shard_kv_pool(pools: List[Dict[str, torch.Tensor]], mesh: Mesh) -> List[Shards]:
    """Per-layer page pools cut on ``Hkv``: one :class:`Shards` of pool
    dicts a layer."""
    return _shard_layers(pools, kv_pool_specs("ks" in pools[0]), mesh)


def shard_kv_cache_layered(caches: List[Dict[str, torch.Tensor]], mesh: Mesh) -> List[Shards]:
    """Per-layer fixed caches cut on ``Hkv``."""
    return _shard_layers(caches, kv_cache_layer_specs("ks" in caches[0]), mesh)


def draft_kv_cache_specs(quantized: bool) -> Dict[str, int]:
    """The resident draft model's fixed caches (engine/spec_draft.py):
    laid out exactly as the target's, KV heads on the model axis, so a
    slot's draft rows live with its target rows on every shard."""
    return kv_cache_layer_specs(quantized)


def shard_draft_kv_cache(caches: List[Dict[str, torch.Tensor]], mesh: Mesh) -> List[Shards]:
    """The draft model's per-layer caches cut by :func:`draft_kv_cache_specs`:
    the target's rule, one implementation."""
    return shard_kv_cache_layered(caches, mesh)
