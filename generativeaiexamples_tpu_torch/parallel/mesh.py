"""The device mesh: JAX's four axes, (``pipe``, ``data``, ``seq``, ``model``).

Counterpart of generativeaiexamples_tpu/parallel/mesh.py. One controlling
process drives every device of its part of the mesh (the JAX package's
single-controller ``shard_map``), so a mesh is an ordered list of devices
in JAX's axis order: ``pipe`` outermost, ``model`` innermost, device
``((p * data + d) * seq + s) * model + m`` at coordinate (p, d, s, m).

- ``model``: tensor parallelism; a ``model`` sub-mesh (:meth:`Mesh.stage`
  under PP, :meth:`Mesh.tp_mesh` in training) is what a
  ``tp_kernels.TPContext`` runs on, shard ``i`` on its ``devices[i]``;
- ``pipe``: pipeline stages (parallel/pp_serving.py, pipeline.py);
- ``data``: data replicas of a training step (models/train.py), each
  with its own rows of the batch (:meth:`Mesh.replica`);
- ``seq``: a replica's sequence shards, each with its own positions
  (:meth:`Mesh.ring`, parallel/ring_attention.py).

A mesh may span several processes (parallel/multihost.py): the process
granule is an outer (``pipe``, ``data``) coordinate, as in JAX's hybrid
mesh, and a process drives only its own granule's devices
(:meth:`Mesh.process_replicas`).

A mesh may name one device more than once (``[cuda:0, cuda:0]``): the
counterpart of JAX's explicit ``mesh=`` over virtual devices, which is how
tests and ``chip_smoke.py`` run every shard's kernels at their local tile
shapes, and the real reduce, on one device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


class Mesh:
    """``pipe`` x ``data`` x ``seq`` x ``model`` over ``devices`` in that
    order, ``model = len(devices) // (pipe * data * seq)``; ``processes``
    is the number of process granules over the outer axes (1: every
    device is this process's)."""

    def __init__(self, devices: Sequence, pipe: int = 1, data: int = 1, seq: int = 1,
                 processes: int = 1) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        outer = pipe * data * seq
        if min(pipe, data, seq) < 1 or len(devices) % outer:
            raise ValueError(
                f"{len(devices)} devices not divisible by pipe={pipe} * data={data} * seq={seq}"
            )
        if processes < 1 or (pipe * data) % processes:
            raise ValueError(f"{processes} processes do not divide pipe={pipe} * data={data}")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.pipe, self.data, self.seq, self.processes = pipe, data, seq, processes

    @property
    def size(self) -> int:
        """Every device of the mesh."""
        return len(self.devices)

    @property
    def tp(self) -> int:
        """Shards of the ``model`` axis."""
        return self.size // (self.pipe * self.data * self.seq)

    @property
    def shape(self) -> Dict[str, int]:
        """Every axis and its size, in JAX's order (JAX's ``mesh.shape``)."""
        return {PIPE_AXIS: self.pipe, DATA_AXIS: self.data, SEQ_AXIS: self.seq,
                MODEL_AXIS: self.tp}

    @property
    def home(self) -> torch.device:
        """The first shard's device: where the replicated activations, the
        embedding, the page tables and the sampler live."""
        return self.devices[0]

    def device(self, p: int = 0, d: int = 0, s: int = 0, m: int = 0) -> torch.device:
        """The device at coordinate (pipe, data, seq, model)."""
        return self.devices[((p * self.data + d) * self.seq + s) * self.tp + m]

    def stage(self, s: int) -> "Mesh":
        """Stage ``s``'s (``data``, ``seq``, ``model``) sub-mesh."""
        if not 0 <= s < self.pipe:
            raise IndexError(f"stage {s} of a mesh of {self.pipe} stages")
        per = self.size // self.pipe
        return Mesh(self.devices[s * per:(s + 1) * per], data=self.data, seq=self.seq)

    def replica(self, d: int) -> "Mesh":
        """Data replica ``d``'s (``pipe``, ``seq``, ``model``) sub-mesh."""
        if not 0 <= d < self.data:
            raise IndexError(f"data replica {d} of a mesh of {self.data}")
        return Mesh([self.device(p, d, s, m) for p in range(self.pipe) for s in range(self.seq)
                     for m in range(self.tp)], pipe=self.pipe, seq=self.seq)

    def tp_mesh(self, d: int = 0, s: int = 0) -> "Mesh":
        """The ``model`` sub-mesh of data replica ``d``'s sequence shard
        ``s`` (stage 0): the devices one ``TPContext`` runs on."""
        return Mesh([self.device(0, d, s, m) for m in range(self.tp)])

    def ring(self, d: int = 0, m: int = 0) -> List[torch.device]:
        """Data replica ``d``'s ``seq`` ring at model shard ``m`` (stage
        0): sequence shard ``s`` on ``ring[s]``."""
        return [self.device(0, d, s, m) for s in range(self.seq)]

    def process_replicas(self, rank: int) -> List[int]:
        """The data replicas process ``rank`` drives: its granule's, in
        order (every replica with one process)."""
        if self.pipe > 1 and self.processes > 1:
            raise ValueError("the pipe axis is served within one process")
        per = self.data // self.processes
        return list(range(rank * per, (rank + 1) * per))

    def distinct(self) -> List[torch.device]:
        """The devices the mesh spans, each once, in mesh order."""
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
        axes = "".join(f", {name}={getattr(self, name)}" for name in ("pipe", "data", "seq")
                       if getattr(self, name) > 1)
        procs = f", processes={self.processes}" if self.processes > 1 else ""
        return f"Mesh({[str(d) for d in self.devices]}{axes}{procs})"


def visible_devices() -> List[torch.device]:
    """Every visible CUDA device, or the CPU where there is none."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def create_mesh(tensor_parallelism: int = -1, data_parallelism: int = 1,
                seq_parallelism: int = 1, pipeline_parallelism: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A (``pipe``, ``data``, ``seq``, ``model``) mesh over ``devices``
    (default: :func:`visible_devices`), JAX's signature and argument
    order. ``tensor_parallelism=-1`` takes every device the other axes
    leave, the counterpart of NIM's ``INFERENCE_GPU_COUNT=all``; devices
    that do not divide, or do not suffice, raise with the JAX function's
    messages."""
    devices = list(devices if devices is not None else visible_devices())
    n = len(devices)
    for name, value in (("data", data_parallelism), ("seq", seq_parallelism),
                        ("pipeline", pipeline_parallelism)):
        if value < 1:
            raise ValueError(f"{name}_parallelism must be >= 1, got {value}")
    other = data_parallelism * seq_parallelism * pipeline_parallelism
    if tensor_parallelism == -1:
        if n % other:
            raise ValueError(
                f"{n} devices not divisible by pipe={pipeline_parallelism} * "
                f"data={data_parallelism} * seq={seq_parallelism}"
            )
        tensor_parallelism = n // other
    if tensor_parallelism < 1:
        raise ValueError(f"tensor_parallelism must be -1 or >= 1, got {tensor_parallelism}")
    total = other * tensor_parallelism
    if total > n:
        raise ValueError(f"Mesh wants {total} devices; only {n} available")
    return Mesh(devices[:total], pipe=pipeline_parallelism, data=data_parallelism,
                seq=seq_parallelism)


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
