"""The device mesh of tensor- and pipeline-parallel serving.

Counterpart of generativeaiexamples_tpu/parallel/mesh.py for its ``pipe``
and ``model`` axes: one controlling process drives every shard (the JAX
package's single-controller ``shard_map``), so a mesh is an ordered list
of devices. The ``pipe`` axis is outermost, as in JAX: stage ``s`` holds
``devices[s * tp:(s + 1) * tp]``, its ``model`` sub-mesh (:meth:`Mesh.stage`),
and shard ``i`` of that stage runs on the sub-mesh's ``devices[i]``. The
data and sequence axes of the JAX mesh are not served (ROADMAP queue 1
item 9c).

A mesh may name one device more than once (``[cuda:0, cuda:0]``): the
counterpart of JAX's explicit ``mesh=`` over virtual devices, which is how
tests and ``chip_smoke.py`` run every stage and every shard's kernels at
their local tile shapes, and the real reduce, on one device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


class Mesh:
    """``pipe`` stages of ``size // pipe`` shards each over ``devices``,
    stage-major; with ``pipe`` 1 shard ``i`` of the ``model`` axis runs on
    ``devices[i]``."""

    def __init__(self, devices: Sequence, pipe: int = 1) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if pipe < 1 or len(devices) % pipe:
            raise ValueError(f"{len(devices)} devices not divisible by pipe={pipe}")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.pipe = pipe

    @property
    def size(self) -> int:
        """Every device of the mesh: stages times shards."""
        return len(self.devices)

    @property
    def tp(self) -> int:
        """Shards of the ``model`` axis (a stage's)."""
        return self.size // self.pipe

    @property
    def shape(self) -> Dict[str, int]:
        if self.pipe > 1:
            return {PIPE_AXIS: self.pipe, MODEL_AXIS: self.tp}
        return {MODEL_AXIS: self.size}

    @property
    def home(self) -> torch.device:
        """The first shard's device: where the replicated activations, the
        embedding, the page tables and the sampler live."""
        return self.devices[0]

    def stage(self, s: int) -> "Mesh":
        """Stage ``s``'s ``model`` sub-mesh."""
        if not 0 <= s < self.pipe:
            raise IndexError(f"stage {s} of a mesh of {self.pipe} stages")
        return Mesh(self.devices[s * self.tp:(s + 1) * self.tp])

    def distinct(self) -> List[torch.device]:
        """The devices the mesh spans, each once, in shard order."""
        out: List[torch.device] = []
        for dev in self.devices:
            if dev not in out:
                out.append(dev)
        return out

    def __getitem__(self, index: slice) -> "Mesh":
        """The ``model`` mesh of a slice of the devices, in order."""
        if not isinstance(index, slice):
            raise TypeError("a mesh is sliced, not indexed: mesh.devices[i] is shard i's device")
        return Mesh(self.devices[index])

    def __repr__(self) -> str:
        pipe = f", pipe={self.pipe}" if self.pipe > 1 else ""
        return f"Mesh({[str(d) for d in self.devices]}{pipe})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device, or the CPU where there is none."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_mesh(tensor_parallelism: int = -1, pipeline_parallelism: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A (``pipe``, ``model``) mesh over ``devices`` (default:
    :func:`visible_devices`), ``pipe`` outermost. ``tensor_parallelism=-1``
    takes every device the pipe axis leaves, the counterpart of NIM's
    ``INFERENCE_GPU_COUNT=all``; asking for more devices than there are
    raises, with the JAX function's messages."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    if tensor_parallelism == -1:
        if n % pipeline_parallelism:
            raise ValueError(
                f"{n} devices not divisible by pipe={pipeline_parallelism} * data=1 * seq=1"
            )
        tensor_parallelism = n // pipeline_parallelism
    if tensor_parallelism < 1:
        raise ValueError(f"tensor_parallelism must be -1 or >= 1, got {tensor_parallelism}")
    total = pipeline_parallelism * tensor_parallelism
    if total > n:
        raise ValueError(f"Mesh wants {total} devices; only {n} available")
    return Mesh(devices[:total], pipe=pipeline_parallelism)


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
