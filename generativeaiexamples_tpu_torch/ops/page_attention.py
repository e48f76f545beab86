"""Ragged GQA attention over the paged KV pool (bf16 pool).

Counterpart of generativeaiexamples_tpu/ops/page_attention.py. The pool
keeps pages ``[P, page, Hkv, Dh]`` token-major; each row's page table maps
its logical pages to physical ones (page 0 is the scratch page). Query
token ``t`` of row ``b`` sits at position ``min(positions[b] + t, S - 1)``
and attends cache positions ``<=`` that; pages past a row's last live token
are never read.

- :func:`paged_attention`: on CUDA tensors it launches
  ``csrc/page_attention.cu`` (one block per (row, KV head), online f32
  softmax over the row's live pages only); on CPU tensors it runs
  :func:`paged_attention_plain`.
- :func:`supports_geometry`: the port's predicate for what the kernel
  serves. The engine refuses to build on CUDA when it says no, instead of
  falling back to the gather.

The int8 and int4 pools of the JAX kernel are not ported yet.
"""
from __future__ import annotations

import ctypes
import math

import torch

from generativeaiexamples_tpu_torch.ops import _build

# Query rows (T * Hq) one call may carry, as in the JAX kernel: decode
# (T = 1) and short multi-query chunks fit, prefill-length chunks do not.
MAX_QUERY_ROWS = 512
# Head dims csrc/page_attention.cu is instantiated for.
_HEAD_DIMS = (64, 128, 256)

_SIGNATURES = {
    "paged_attention_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ],
}


def paged_attention_plain(q, k, v, tables, positions) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each row's whole
    table window, mask to positions <= each query's position, f32 softmax,
    f32 P.V, one bf16 rounding at the end."""
    B, T, Hq, Dh = q.shape
    _, page, Hkv, _ = k.shape
    Pmax = tables.shape[1]
    S = Pmax * page
    G = Hq // Hkv
    tables = tables.long()
    gk = k[tables].reshape(B, S, Hkv, Dh).float()
    gv = v[tables].reshape(B, S, Hkv, Dh).float()
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    sc = torch.einsum("btkgd,bskd->bkgts", qg, gk) / math.sqrt(Dh)
    q_pos = torch.clamp(
        positions.long()[:, None] + torch.arange(T, device=q.device)[None, :], max=S - 1
    )
    mask = torch.arange(S, device=q.device)[None, None, :] <= q_pos[:, :, None]
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, gv)
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


def _launch(q, k, v, tables, positions) -> torch.Tensor:
    B, T, Hq, Dh = q.shape
    _, page, Hkv, _ = k.shape
    Pmax = tables.shape[1]
    if not supports_geometry(page, Dh, Hq, Hkv, query_len=T):
        raise ValueError(
            f"paged_attention: geometry page={page} Dh={Dh} Hq={Hq} Hkv={Hkv} T={T} "
            "is not served by the CUDA kernel"
        )
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError("paged_attention: the CUDA kernel serves bf16 q and pools only")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("paged_attention: pools must be contiguous")
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _build.load("page_attention", _SIGNATURES)
    code = lib.paged_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, Dh, page, Pmax,
        1.0 / math.sqrt(Dh), _build.stream_ptr(q),
    )
    _build.check(code, "paged_attention")
    paged_attention.launches += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [B, T, Hq, Dh] bf16
    k: torch.Tensor,  # [P, page, Hkv, Dh] bf16 page pool
    v: torch.Tensor,  # [P, page, Hkv, Dh]
    tables: torch.Tensor,  # [B, Pmax] int32 physical page ids per row
    positions: torch.Tensor,  # [B] int32, the FIRST query token's position
) -> torch.Tensor:
    """Attention output ``[B, T, Hq, Dh]`` over each row's live pages (the
    chunk's own rows must already be in the pool)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k, v, tables, positions)
    return _launch(q, k, v, tables, positions)


paged_attention.launches = 0


def supports_geometry(
    page_size: int,
    head_dim: int,
    num_heads: int,
    num_kv_heads: int,
    query_len: int = 1,
    kv_dtype: str = "bfloat16",
) -> bool:
    """Whether the CUDA kernel serves this pool geometry: the JAX
    predicate's structural half (GQA divisibility, the query-row cap that
    keeps prefill-length chunks on the gather, a positive page) plus what
    ``csrc/page_attention.cu`` needs (a bf16 pool, a head dim it is
    instantiated for). The TPU's lane and sublane tiling rules do not
    apply on the GPU."""
    return (
        kv_dtype == "bfloat16"
        and query_len >= 1
        and num_kv_heads >= 1
        and num_heads % num_kv_heads == 0
        and query_len * num_heads <= MAX_QUERY_ROWS
        and page_size >= 1
        and head_dim in _HEAD_DIMS
    )
