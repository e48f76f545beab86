"""Parallelism: JAX's (``pipe``, ``data``, ``seq``, ``model``) mesh
(mesh.py), the Megatron cuts of parameters and caches (sharding.py), the
kernels on each shard's local tile (tp_kernels.py), the PP x TP stage walk
(pp_serving.py), the GPipe forward (pipeline.py), ring attention over the
``seq`` axis (ring_attention.py) and the process group and hybrid mesh of
many processes (multihost.py)."""
from generativeaiexamples_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    Mesh,
    create_mesh,
    tier_submeshes,
)
from generativeaiexamples_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
)
from generativeaiexamples_tpu_torch.parallel.sharding import (
    Shards,
    activation_spec,
    draft_kv_cache_specs,
    kv_cache_layer_specs,
    kv_pool_specs,
    layer_param_specs,
    param_specs,
    shard_draft_kv_cache,
    shard_kv_cache_layered,
    shard_kv_pool,
    shard_params,
    token_spec,
)

__all__ = [
    "DATA_AXIS",
    "SEQ_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "Mesh",
    "create_mesh",
    "tier_submeshes",
    "Shards",
    "param_specs",
    "layer_param_specs",
    "activation_spec",
    "token_spec",
    "kv_pool_specs",
    "kv_cache_layer_specs",
    "draft_kv_cache_specs",
    "shard_params",
    "shard_kv_pool",
    "shard_kv_cache_layered",
    "shard_draft_kv_cache",
    "ring_attention",
    "reference_attention",
]
