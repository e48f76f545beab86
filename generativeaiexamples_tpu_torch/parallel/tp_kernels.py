"""The serving kernels on each shard's local Megatron tile.

Counterpart of generativeaiexamples_tpu/parallel/tp_kernels.py. The JAX
package runs every Pallas kernel per device through ``shard_map`` with an
explicit ``psum`` where a layout contracts across shards; the port's one
controlling process does the same by hand: it calls each kernel's wrapper
once a shard, on that shard's tile and device, and sums the row-parallel
partials itself. Every launch counts in its wrapper, so a TP=N step
launches each kernel N times where TP=1 launches it once.

Layout contracts (the cuts of parallel/sharding.py):

- column-parallel matmul (wq/wk/wv/w_gate/w_up/lm_head): x replicated,
  the weight cut on its output axis; the shards' outputs are concatenated
  on the output axis. No reduce.
- row-parallel matmul (wo/w_down): x cut on its contraction axis, the
  weight on its rows, the pack's scale whole on every shard; each shard's
  output goes to f32, the partials are summed in shard order and the sum
  cast back to the output dtype (JAX's ``psum(y.astype(f32))``), so TP=1
  and TP=N differ by the one rounding of each partial. The reduce runs
  under the context's ``annotate("tp.reduce")`` label (a no-op unless the
  engine profiles), which is how a trace tells its kernels, JAX's
  ``collective`` category, from the model's own adds
  (utils/device_trace.py).
- attention (flash prefill, the paged read, the int8 fixed-cache decode):
  q, k and v cut on their head axis; GQA stays local while the shards
  divide both head counts. No reduce.

Replicated activations, page tables and positions live on the first
shard's device (``mesh.home``); a shard on another card receives its
slice by a device-to-device copy and its output comes back the same way
(the reduce sums on ``home``, in shard order, whatever the placement, so
the bits do not depend on it). Shards on one device copy nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch

from generativeaiexamples_tpu_torch.ops import (
    decode_attention,
    flash_attention,
    int8_matmul,
    page_attention,
)
from generativeaiexamples_tpu_torch.parallel.mesh import Mesh
from generativeaiexamples_tpu_torch.parallel.sharding import Shards


def _no_label(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Everything the model functions need to run kernels under TP."""

    mesh: Mesh
    shards: int  # size of the model axis
    # the profiling label factory of the row reduce
    # (utils/profiling.annotation_scope); a no-op by default
    annotate: Callable = dataclasses.field(default=_no_label, compare=False, repr=False)

    def __post_init__(self) -> None:
        if self.shards != self.mesh.size:
            raise ValueError(f"TPContext: {self.shards} shards on a mesh of {self.mesh.size}")

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.devices

    @property
    def home(self) -> torch.device:
        return self.mesh.home

    @property
    def spans_devices(self) -> bool:
        """Whether the shards sit on more than one device."""
        return len(self.mesh.distinct()) > 1


def supports_model_config(cfg, shards: int) -> bool:
    """Whether every sharded projection axis divides evenly: the head
    counts (column packs align shards with heads), the MLP width, and the
    vocab (lm_head columns)."""
    return (
        shards > 1
        and cfg.num_heads % shards == 0
        and cfg.num_kv_heads % shards == 0
        and cfg.intermediate_size % shards == 0
        and cfg.vocab_size % shards == 0
    )


def _scope(tp: TPContext, device: torch.device):
    """The CUDA device a shard's launches go to: the ctypes wrappers launch
    on the thread's current device. One device needs no switch."""
    if tp.spans_devices and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def scatter(x: torch.Tensor, tp: TPContext, dim: int) -> List[torch.Tensor]:
    """``x`` (replicated, on ``home``) cut into the shards' slices along
    ``dim``, each contiguous on its shard's device."""
    return [p.to(d).contiguous() for p, d in zip(torch.chunk(x, tp.shards, dim=dim), tp.devices)]


def gather(parts: Sequence[torch.Tensor], tp: TPContext, dim: int) -> torch.Tensor:
    """The shards' outputs concatenated along ``dim`` on ``home``."""
    return torch.cat([p.to(tp.home) for p in parts], dim=dim)


def reduce_sum(parts: Sequence[torch.Tensor], tp: TPContext) -> torch.Tensor:
    """The row-parallel reduce: each partial to f32, summed in shard order
    on ``home``, cast back to the partials' dtype."""
    with tp.annotate("tp.reduce"):
        acc = parts[0].to(tp.home, torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(tp.home, torch.float32)
        return acc.to(parts[0].dtype)


def _local(a, i: int, dev: torch.device):
    """Shard ``i``'s argument: a :class:`Shards` (or list) passes its
    piece, a tensor (or a tuple of them) moves to the shard's device (a
    no-op on the same device), anything else passes as it is."""
    if isinstance(a, (Shards, list)):
        return a[i]
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    if isinstance(a, tuple):
        return tuple(_local(x, i, dev) for x in a)
    return a


def map_shards(fn: Callable, tp: TPContext, *args) -> List:
    """``fn`` once a shard, under that shard's device, on each argument's
    shard view (:func:`_local`)."""
    out = []
    for i, dev in enumerate(tp.devices):
        local = [_local(a, i, dev) for a in args]
        with _scope(tp, dev):
            out.append(fn(*local))
    return out


def _local_matmul(x: torch.Tensor, w, mode: str) -> torch.Tensor:
    """One shard's tile product: a pack through ``packed_matmul`` (the
    mode's kernel at decode shapes, the dequantized or W8A8 prefill path
    above ``M_MAX``, as on one device), a dense tile through matmul."""
    if isinstance(w, dict):
        return int8_matmul.packed_matmul(x, w, mode)
    return x @ w


def packed_matmul_tp(x: torch.Tensor, w: Shards, tp: TPContext, kind: str, mode: str = "int8"):
    """``x @ w`` over the model axis for a weight cut by sharding.py: int8
    packs (``mode`` as ``int8_matmul.packed_matmul``) or dense tiles.

    ``kind`` is the projection's Megatron role (ops/quant.py PACK_KINDS):
    ``"column"`` concatenates the shards' output features; ``"row"`` cuts
    x's last axis and reduces with :func:`reduce_sum`. Under ``"w8a8"`` a
    row shard quantizes its own K slice of each token, so TP=N differs
    from TP=1 by that activation rounding too, as in JAX."""
    if kind == "column":
        return gather(map_shards(lambda wl, xl: _local_matmul(xl, wl, mode), tp, w, x), tp, -1)
    if kind == "row":
        xs = scatter(x, tp, -1)
        return reduce_sum(map_shards(lambda wl, xl: _local_matmul(xl, wl, mode), tp, w, xs), tp)
    raise ValueError(f"kind must be 'column' or 'row', got {kind!r}")


def flash_supported(cfg, shards: int, T: int) -> bool:
    """Whether the flash prefill kernel can run head-sharded: shards
    divide both head counts and the kernel accepts the shape."""
    return (
        cfg.num_heads % shards == 0
        and cfg.num_kv_heads % shards == 0
        and flash_attention.supported(T, cfg.head_dim)
    )


def flash_attention_tp(q, k, v, tp: TPContext) -> torch.Tensor:
    """Causal flash prefill with the head axis sharded: q ``[B, T, Hq,
    D]``, k/v ``[B, T, Hkv, D]`` (replicated, on ``home``); each shard runs
    the kernel on its Hq/N query heads against its Hkv/N KV heads."""
    outs = map_shards(
        flash_attention.flash_attention_causal, tp,
        scatter(q, tp, 2), scatter(k, tp, 2), scatter(v, tp, 2),
    )
    return gather(outs, tp, 2)


def decode_attention_supported(cfg, shards: int, S: int) -> bool:
    """Whether the int8-KV decode kernel can run head-sharded: the LOCAL
    geometry (heads divided by shards) must be one the kernel serves."""
    return (
        cfg.num_heads % shards == 0
        and cfg.num_kv_heads % shards == 0
        and decode_attention.supported(
            S, cfg.head_dim, cfg.num_heads // shards, cfg.num_kv_heads // shards
        )
    )


def paged_attention_tp(
    q: torch.Tensor, k: Shards, v: Shards, tables: torch.Tensor, positions: torch.Tensor,
    k_scale: Optional[Shards] = None, v_scale: Optional[Shards] = None, *, tp: TPContext,
) -> torch.Tensor:
    """Ragged page attention with the head axis sharded: q ``[B, T, Hq,
    Dh]`` on ``home``; each shard's pool ``[P, page, Hkv/N, Dh]`` (bf16,
    int8, or uint8 ``Dh // 2`` for int4) with its scales ``[P, page,
    Hkv/N]``; tables and positions replicated. The engine gates this path
    on ``page_attention.supports_geometry`` of the LOCAL heads."""
    qs = scatter(q, tp, 2)
    if k_scale is None:
        outs = map_shards(page_attention.paged_attention, tp, qs, k, v, tables, positions)
    else:
        outs = map_shards(
            page_attention.paged_attention, tp, qs, k, v, tables, positions, k_scale, v_scale
        )
    return gather(outs, tp, 2)


def decode_attention_tp(
    q: torch.Tensor, k_q: Shards, k_s: Shards, v_q: Shards, v_s: Shards,
    positions: torch.Tensor, tp: TPContext,
) -> torch.Tensor:
    """One decode step over the int8 head-major fixed cache, heads
    sharded: q ``[B, Hq, Dh]`` on ``home``; each shard's caches ``[B,
    Hkv/N, S, Dh]`` with ``[B, Hkv/N, 1, S]`` scales; positions
    replicated. Each shard streams only its own KV heads' rows."""
    outs = map_shards(
        decode_attention.decode_attention, tp, scatter(q, tp, 1), k_q, k_s, v_q, v_s, positions
    )
    return gather(outs, tp, 1)
