"""Ragged GQA attention over the paged KV pool (bf16, int8 and int4 pools).

Counterpart of generativeaiexamples_tpu/ops/page_attention.py. The pool
keeps pages ``[P, page, Hkv, Dh]`` token-major; each row's page table maps
its logical pages to physical ones (page 0 is the scratch page). Query
token ``t`` of row ``b`` sits at position ``min(positions[b] + t, S - 1)``
and attends cache positions ``<=`` that; pages past a row's last live token
are never read.

Three pools, told apart as in JAX by their dtype and scales:
- bf16: ``k``/``v`` bf16 ``[P, page, Hkv, Dh]``;
- int8: ``k``/``v`` int8 ``[P, page, Hkv, Dh]`` with f32 per-(token, head)
  scales ``k_scale``/``v_scale`` ``[P, page, Hkv]``;
- int4: ``k``/``v`` uint8 ``[P, page, Hkv, Dh // 2]``, two values a byte
  (``models/llama.quantize_kv_int4``'s split halves), with the same scales.
The scales fold in after the integer dots: a score is
``dot(q, k_int) * k_scale * (1 / sqrt(Dh))`` and P.V sums
``p * v_scale * v_int``.

- :func:`paged_attention`: on CUDA tensors it launches
  ``csrc/page_attention.cu`` (each row's live tokens split across blocks of
  :func:`split_plan`'s size, online f32 softmax per split, the splits
  merged in a second kernel of the same call); on CPU tensors it runs
  :func:`paged_attention_plain`.
- :func:`supports_geometry`: the port's predicate for what the kernel
  serves. The engine refuses to build on CUDA when it says no, instead of
  falling back to the gather.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from generativeaiexamples_tpu_torch.ops import _build

# Query rows (T * Hq) one call may carry, as in the JAX kernel: decode
# (T = 1) and short multi-query chunks fit, prefill-length chunks do not.
MAX_QUERY_ROWS = 512
# Tokens of a row one block of csrc/page_attention.cu walks (rounded down to
# whole pages, at least one page): a long row is split across
# ceil(live tokens / split) blocks per KV head, merged afterwards.
SPLIT_TOKENS = 512
# Head dims csrc/page_attention.cu is instantiated for.
_HEAD_DIMS = (64, 128, 256)
# Pool kinds, as csrc/page_attention.cu numbers them.
_POOL_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.uint8: 2}
KV_DTYPES = ("bfloat16", "int8", "int4")

_SIGNATURES = {
    "paged_attention_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ],
}


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """The int4 pool's rows: uint8 [..., Dh // 2] -> int8 [..., Dh] with
    values in [-8, 7]. The low nibble of byte i is lane i, the high nibble
    lane i + Dh/2 (``models/llama.quantize_kv_int4``'s split halves)."""
    w = packed.to(torch.int32)
    lo = w & 0xF
    hi = (w >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def split_plan(pmax: int, page: int) -> tuple:
    """(tokens per split, splits per row) for tables of ``pmax`` pages of
    ``page`` tokens: whole pages, ``SPLIT_TOKENS`` of them where the page
    divides it, and enough splits to cover the table's whole window. It
    reads only the table's shape, never the positions, so the launch
    needs nothing from the device."""
    if pmax < 1 or page < 1:
        raise ValueError(f"split_plan: pmax={pmax} and page={page} must be positive")
    split_tokens = page * max(1, SPLIT_TOKENS // page)
    return split_tokens, -(-pmax * page // split_tokens)


def paged_attention_plain(
    q, k, v, tables, positions, k_scale=None, v_scale=None
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each row's whole
    table window, mask to positions <= each query's position, f32 scores
    (the K scale folded after the dot), f32 softmax, f32 P.V over the
    V-scaled probabilities, one rounding to q's dtype at the end."""
    B, T, Hq, Dh = q.shape
    page, Hkv = k.shape[1], k.shape[2]
    Pmax = tables.shape[1]
    S = Pmax * page
    G = Hq // Hkv
    tables = tables.long()

    def window(pool):
        g = pool[tables]
        g = unpack_int4(g) if g.dtype == torch.uint8 else g
        return g.reshape(B, S, Hkv, Dh).float()

    gk, gv = window(k), window(v)
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    sc = torch.einsum("btkgd,bskd->bkgts", qg, gk)
    if k_scale is None:
        sc = sc / math.sqrt(Dh)
    else:
        ks = k_scale[tables].reshape(B, S, Hkv).float().permute(0, 2, 1)  # [B, Hkv, S]
        sc = sc * (ks * (1.0 / math.sqrt(Dh)))[:, :, None, None, :]
    q_pos = torch.clamp(
        positions.long()[:, None] + torch.arange(T, device=q.device)[None, :], max=S - 1
    )
    mask = torch.arange(S, device=q.device)[None, None, :] <= q_pos[:, :, None]
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    if v_scale is not None:
        vs = v_scale[tables].reshape(B, S, Hkv).float().permute(0, 2, 1)
        p = p * vs[:, :, None, None, :]
    out = torch.einsum("bkgts,bskd->btkgd", p, gv)
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


def _launch(q, k, v, tables, positions, k_scale, v_scale) -> torch.Tensor:
    B, T, Hq, Dh = q.shape
    _, page, Hkv, _ = k.shape
    Pmax = tables.shape[1]
    kind = _POOL_KINDS.get(k.dtype)
    kv_dtype = None if kind is None else KV_DTYPES[kind]
    if kind is None or v.dtype != k.dtype or q.dtype != torch.bfloat16:
        raise ValueError(
            f"paged_attention: the CUDA kernel serves bf16 q over bf16, int8 or "
            f"uint8 (int4) pools, got q {q.dtype}, k {k.dtype}, v {v.dtype}"
        )
    if not supports_geometry(page, Dh, Hq, Hkv, query_len=T, kv_dtype=kv_dtype):
        raise ValueError(
            f"paged_attention: geometry page={page} Dh={Dh} Hq={Hq} Hkv={Hkv} T={T} "
            f"kv_dtype={kv_dtype} is not served by the CUDA kernel"
        )
    row = Dh // 2 if kind == 2 else Dh
    if tuple(k.shape[3:]) != (row,) or k.shape != v.shape:
        raise ValueError(f"paged_attention: pool rows must be {row} wide, got {tuple(k.shape)}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("paged_attention: pools must be contiguous")
    scaled = kind != 0
    if scaled != (k_scale is not None) or scaled != (v_scale is not None):
        raise ValueError("paged_attention: int8 and int4 pools need both scale planes, bf16 none")
    if scaled:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != tuple(k.shape[:3]) or not s.is_contiguous():
                raise ValueError(
                    f"paged_attention: scales must be contiguous f32 {tuple(k.shape[:3])}, "
                    f"got {s.dtype} {tuple(s.shape)}"
                )
    q = q.contiguous()
    tables = tables.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    split_tokens, nsplit = split_plan(Pmax, page)
    # each split's (max, sum, accumulator) per query row, for the merge; a
    # single split writes out directly and needs none
    ws = None if nsplit == 1 else torch.empty(
        B * Hkv * nsplit * T * (Hq // Hkv) * (Dh + 2), dtype=torch.float32, device=q.device)
    lib = _build.load("page_attention", _SIGNATURES)
    code = lib.paged_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if scaled else None, v_scale.data_ptr() if scaled else None,
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, T, Hq, Hkv, Dh, page, Pmax, kind, 1.0 / math.sqrt(Dh), split_tokens, nsplit,
        _build.stream_ptr(q),
    )
    _build.check(code, "paged_attention")
    paged_attention.launches[kv_dtype] += 1
    return out


def paged_attention(
    q: torch.Tensor,  # [B, T, Hq, Dh] bf16
    k: torch.Tensor,  # [P, page, Hkv, Dh] bf16 or int8, or [P, page, Hkv, Dh // 2] uint8
    v: torch.Tensor,  # same as k
    tables: torch.Tensor,  # [B, Pmax] int32 physical page ids per row
    positions: torch.Tensor,  # [B] int32, the FIRST query token's position
    k_scale: Optional[torch.Tensor] = None,  # [P, page, Hkv] f32 (int8 / int4 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention output ``[B, T, Hq, Dh]`` over each row's live pages (the
    chunk's own rows must already be in the pool)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k, v, tables, positions, k_scale, v_scale)
    return _launch(q, k, v, tables, positions, k_scale, v_scale)


# launches of the CUDA kernel, by pool dtype
paged_attention.launches = dict.fromkeys(KV_DTYPES, 0)


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
    keeps prefill-length chunks on the gather, a positive page, an even
    head dim for int4) plus what ``csrc/page_attention.cu`` needs (a pool
    dtype and a head dim it is instantiated for). The TPU's lane and
    sublane tiling rules do not apply on the GPU."""
    return (
        kv_dtype in KV_DTYPES
        and query_len >= 1
        and num_kv_heads >= 1
        and num_heads % num_kv_heads == 0
        and query_len * num_heads <= MAX_QUERY_ROWS
        and page_size >= 1
        and (kv_dtype != "int4" or head_dim % 2 == 0)
        and head_dim in _HEAD_DIMS
    )
