"""The device mesh of tensor-parallel serving.

Counterpart of generativeaiexamples_tpu/parallel/mesh.py for its ``model``
axis alone: one controlling process drives every shard (the JAX package's
single-controller ``shard_map``), so a mesh is an ordered list of devices,
shard ``i`` on ``devices[i]``. The data, sequence and pipeline axes of the
JAX mesh are not served (ROADMAP queue 1 item 9b, 9c).

A mesh may name one device more than once (``[cuda:0, cuda:0]``): the
counterpart of JAX's explicit ``mesh=`` over virtual devices, which is how
tests and ``chip_smoke.py`` run every shard's kernels at their local tile
shapes, and the real reduce, on one device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

MODEL_AXIS = "model"


class Mesh:
    """Shard ``i`` of the ``model`` axis runs on ``devices[i]``."""

    def __init__(self, devices: Sequence) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        return {MODEL_AXIS: self.size}

    @property
    def home(self) -> torch.device:
        """The first shard's device: where the replicated activations, the
        embedding, the page tables and the sampler live."""
        return self.devices[0]

    def distinct(self) -> List[torch.device]:
        """The devices the mesh spans, each once, in shard order."""
        out: List[torch.device] = []
        for dev in self.devices:
            if dev not in out:
                out.append(dev)
        return out

    def __getitem__(self, index: slice) -> "Mesh":
        """The mesh of a slice of the shards, in shard order."""
        if not isinstance(index, slice):
            raise TypeError("a mesh is sliced, not indexed: mesh.devices[i] is shard i's device")
        return Mesh(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device, or the CPU where there is none."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_mesh(tensor_parallelism: int = -1, devices: Optional[Sequence] = None) -> Mesh:
    """A ``model`` mesh of ``tensor_parallelism`` shards over ``devices``
    (default: :func:`visible_devices`). ``-1`` takes every device, the
    counterpart of NIM's ``INFERENCE_GPU_COUNT=all``; asking for more
    shards than devices raises, as the JAX function does."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if tensor_parallelism == -1:
        tensor_parallelism = n
    if tensor_parallelism < 1:
        raise ValueError(f"tensor_parallelism must be -1 or >= 1, got {tensor_parallelism}")
    if tensor_parallelism > n:
        raise ValueError(f"Mesh wants {tensor_parallelism} devices; only {n} available")
    return Mesh(devices[:tensor_parallelism])


def tier_submeshes(mesh: Mesh) -> tuple:
    """(prefill, decode) tier meshes for P/D disaggregation
    (engine/scheduler/disagg.py), the JAX function's plan: a one-device
    mesh returns the serving mesh twice (both tiers share the device and
    its page pool); N shards split in halves of the device list, the
    prefill tier first. The split is advisory, as in JAX: dispatch stays
    on the serving mesh and a handoff moves page ownership in the one
    shared pool; disjoint tiers need a cross-pool page transport."""
    if mesh.size < 2:
        return mesh, mesh
    half = mesh.size // 2
    return mesh[:half], mesh[half:2 * half]
