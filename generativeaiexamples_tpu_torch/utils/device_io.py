"""Host <-> device copies that wait for the current stream's work only.

The retrieval side (the BERT encoder, the vector search) runs on CUDA
streams of its own beside the LLM engine's decode on the default stream.
A copy from pageable host memory, or ``.cpu()`` into pageable memory, may
serialize with other streams' work; these stage through pinned memory
instead and, back to the host, wait on an event recorded behind the copy
on the current stream. On the CPU they are plain conversions.
"""
from __future__ import annotations

import numpy as np
import torch


def to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, copied on the current stream without
    waiting (the caching host allocator keeps the pinned staging buffer
    until its copy has run)."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` as a numpy array: on the card, copied into pinned memory
    on the current stream and waited for through an event behind it."""
    if not tensor.is_cuda:
        return tensor.numpy()
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host.numpy()
