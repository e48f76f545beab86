"""Many processes: the process group, the hybrid mesh, the batch slice.

Counterpart of generativeaiexamples_tpu/parallel/multihost.py, on
``torch.distributed``:

- :func:`initialize_distributed` brings the process group up from JAX's
  env contract (``COORDINATOR_ADDRESS`` host:port, ``NUM_PROCESSES``,
  ``PROCESS_ID``; explicit arguments beat the environment), or does
  nothing without a coordinator, so one entry point serves one process
  and many. ``tools/launch.py`` sets the contract for N processes on one
  host.
- The backend: ``nccl`` where every process owns a card of its own,
  ``gloo`` on the CPU and where processes share a card (NCCL refuses two
  ranks on one device, "Duplicate GPU detected", so one card only ever
  runs ``gloo``). Before the group forms, every process posts its host's
  name and visible cards in the coordinator's store, so each decides
  from the same list: ``nccl`` when no host runs more processes than it
  has cards. The choice is logged and :func:`backend` returns it.
- :func:`create_hybrid_mesh` builds JAX's (``pipe``, ``data``, ``seq``,
  ``model``) mesh: the process granule is the outer (``pipe``, ``data``)
  coordinate (JAX's DCN axes) and each process's own devices make the
  inner (``seq``, ``model``) mesh (JAX's ICI axes). Tensor-parallel and
  ring traffic therefore stay inside one process, over its local devices;
  across processes the only collective is a training step's gradient
  all-reduce (models/train.py).

A failed ``init_process_group``, and a collective whose peer died, raise
in every process (``timeout`` bounds each wait), so nothing hangs and
nothing exits 0.

Process ``i`` drives ``cuda:(i % device_count)`` (:func:`local_device`),
the launcher's contract: ``CUDA_VISIBLE_DEVICES`` is left alone.
"""
from __future__ import annotations

import collections
import datetime
import logging
import os
import socket
import time
from typing import List, Optional, Sequence, Tuple

import torch

from generativeaiexamples_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

# how long a process waits for its peers at the rendezvous and in a
# collective before it raises
DEFAULT_TIMEOUT_S = 120.0

_BACKEND: Optional[str] = None
# the store the processes traded their hosts through; kept until shutdown,
# since the group's own rendezvous shares its server (multi-tenant)
_STORE = None


def _dist():
    import torch.distributed as dist

    return dist


def choose_backend(hosts: Sequence[Tuple[str, int]]) -> str:
    """``nccl`` where every process can own a card: ``hosts`` lists each
    process's (host name, visible cards), and no host runs more processes
    than it has cards; else ``gloo`` (the CPU has none)."""
    per_host = collections.Counter(name for name, _ in hosts)
    cards = dict(hosts)
    return "nccl" if all(cards[h] >= n for h, n in per_host.items()) else "gloo"


def _trade_hosts(coordinator_address: str, num_processes: int, process_id: int,
                 timeout_s: float) -> List[Tuple[str, int]]:
    """Every process's (host name, visible cards), in rank order, traded
    through a store at the coordinator's address (the server runs in
    process 0, multi-tenant, so the group's rendezvous there shares it)."""
    global _STORE
    host, port = coordinator_address.rsplit(":", 1)
    try:
        _STORE = _dist().TCPStore(host, int(port), num_processes, process_id == 0,
                                  datetime.timedelta(seconds=timeout_s), multi_tenant=True)
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _STORE.set(f"multihost/host/{process_id}", f"{cards} {socket.gethostname()}")
        posted = [_STORE.get(f"multihost/host/{r}").decode() for r in range(num_processes)]
    except Exception as exc:
        raise RuntimeError(f"init_process_group: process {process_id} of {num_processes} could "
                           f"not meet its peers at {coordinator_address}: {exc}") from exc
    return [(name, int(n)) for n, name in (p.split(" ", 1) for p in posted)]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group if one is configured; returns whether more
    than one process is in it (JAX's return value).

    Reads JAX's env contract where the arguments are omitted:
    ``COORDINATOR_ADDRESS`` (host:port), ``NUM_PROCESSES``, ``PROCESS_ID``.
    With no coordinator it does nothing and returns False. The backend is
    :func:`choose_backend`'s over every process's host; the choice is
    logged."""
    global _BACKEND
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = int(num_processes or os.environ.get("NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None else os.environ.get("PROCESS_ID", "0"))
    hosts = _trade_hosts(coordinator_address, num_processes, process_id, timeout_s)
    chosen = choose_backend(hosts)
    if chosen == "nccl":
        torch.cuda.set_device(local_device(process_id))
    _dist().init_process_group(
        backend=chosen,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _BACKEND = chosen
    logger.info(
        "Process group up: process %d/%d over %s (backend %s, device %s; %d host(s))",
        process_id, num_processes, coordinator_address, chosen, local_device(process_id),
        len({name for name, _ in hosts}),
    )
    return num_processes > 1


def backend() -> Optional[str]:
    """The process group's backend (``nccl`` or ``gloo``); None without
    a group."""
    return _BACKEND


def is_initialized() -> bool:
    return _dist().is_available() and _dist().is_initialized()


def process_count() -> int:
    """Processes in the group; 1 without one."""
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    """This process's rank; 0 without a group."""
    return _dist().get_rank() if is_initialized() else 0


def local_device(rank: Optional[int] = None) -> torch.device:
    """The device process ``rank`` (default: this one) drives:
    ``cuda:(rank % device_count)``, or the CPU without a card."""
    rank = process_index() if rank is None else rank
    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def global_devices() -> List[torch.device]:
    """Every process's devices, process-major (JAX's ``jax.devices()``
    order): each process's :func:`local_device`."""
    return [local_device(r) for r in range(process_count())]


# every all_reduce_sum since the process began: the seconds of all, their
# number, and (bytes, seconds) of each, timed from its input's readiness
# to its result's (a card is synchronized around the call)
COLLECTIVE_STATS = {"all_reduce_s": 0.0, "all_reduce_calls": 0, "all_reduces": []}


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process of the group (``t`` itself in one
    process), on ``t``'s device: ``gloo`` reduces a host copy, ``nccl``
    the card's tensor. A dead peer raises, within the group's timeout."""
    if process_count() == 1:
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    start = time.perf_counter()
    buf = t.detach().to("cpu", copy=True) if backend() == "gloo" else t.detach().clone()
    _dist().all_reduce(buf)
    out = buf.to(t.device)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    seconds = time.perf_counter() - start
    COLLECTIVE_STATS["all_reduce_s"] += seconds
    COLLECTIVE_STATS["all_reduce_calls"] += 1
    COLLECTIVE_STATS["all_reduces"].append((t.numel() * t.element_size(), seconds))
    return out


def barrier() -> None:
    """Wait for every process of the group (nothing in one process)."""
    if process_count() > 1:
        _dist().barrier()


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    global _BACKEND, _STORE
    if is_initialized():
        _dist().destroy_process_group()
    _BACKEND = _STORE = None


def create_hybrid_mesh(
    dcn_data_parallelism: int = -1,
    dcn_pipeline_parallelism: int = 1,
    ici_tensor_parallelism: int = -1,
    ici_seq_parallelism: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(``pipe``, ``data``, ``seq``, ``model``) mesh with the process axes
    outer and each process's own devices inner, JAX's rules for ``-1``:
    ``dcn_data_parallelism=-1`` is one data replica per process granule
    (over the pipe axis), ``ici_tensor_parallelism=-1`` takes each
    granule's devices that the ``seq`` axis leaves. ``devices`` lists
    every process's devices, process-major (default
    :func:`global_devices`); one process makes the plain local mesh."""
    devices = list(devices if devices is not None else global_devices())
    num_granules = max(1, process_count())
    per_granule = len(devices) // num_granules
    if dcn_data_parallelism == -1:
        dcn_data_parallelism = num_granules // dcn_pipeline_parallelism
    if ici_tensor_parallelism == -1:
        ici_tensor_parallelism = per_granule // ici_seq_parallelism
    outer = dcn_pipeline_parallelism * dcn_data_parallelism
    inner = ici_seq_parallelism * ici_tensor_parallelism
    if outer * inner != len(devices) or (num_granules > 1 and outer != num_granules):
        raise ValueError(
            f"mesh pipe={dcn_pipeline_parallelism} x data={dcn_data_parallelism} x "
            f"seq={ici_seq_parallelism} x model={ici_tensor_parallelism} does not tile "
            f"{len(devices)} devices of {num_granules} process(es)"
        )
    return Mesh(devices, pipe=dcn_pipeline_parallelism, data=dcn_data_parallelism,
                seq=ici_seq_parallelism, processes=num_granules)


def local_batch_slice(global_batch: int, mesh: Mesh) -> int:
    """Per-process batch share for data loading (the data axis cut over
    the processes), with JAX's divisibility error over ``data x pipe``."""
    data = mesh.shape["data"] * mesh.shape["pipe"]
    if global_batch % data:
        raise ValueError(f"global batch {global_batch} not divisible by {data}")
    return global_batch // max(1, process_count())
