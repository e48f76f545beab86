"""Tensor- and pipeline-parallel serving: the (``pipe``, ``model``) mesh
(mesh.py), the Megatron cuts of parameters and caches (sharding.py), the
kernels on each shard's local tile (tp_kernels.py), the PP x TP stage walk
(pp_serving.py) and the GPipe forward (pipeline.py)."""
from generativeaiexamples_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    create_mesh,
    tier_submeshes,
)
from generativeaiexamples_tpu_torch.parallel.sharding import (
    Shards,
    draft_kv_cache_specs,
    kv_cache_layer_specs,
    kv_pool_specs,
    layer_param_specs,
    param_specs,
    shard_draft_kv_cache,
    shard_kv_cache_layered,
    shard_kv_pool,
    shard_params,
)

__all__ = [
    "MODEL_AXIS",
    "PIPE_AXIS",
    "Mesh",
    "create_mesh",
    "tier_submeshes",
    "Shards",
    "param_specs",
    "layer_param_specs",
    "kv_pool_specs",
    "kv_cache_layer_specs",
    "draft_kv_cache_specs",
    "shard_params",
    "shard_kv_pool",
    "shard_kv_cache_layered",
    "shard_draft_kv_cache",
]
