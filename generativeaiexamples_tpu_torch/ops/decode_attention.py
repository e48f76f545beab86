"""Decode attention over the fixed KV layout's int8 head-major cache.

Counterpart of generativeaiexamples_tpu/ops/decode_attention.py. The fixed
layout keeps one dense strip of ``S = max_seq_len`` rows per decode slot;
its int8 cache is head-major so each (slot, KV head) strip is contiguous:

  q         [B, Hq, Dh] bf16        one query token per slot
  k_q, v_q  [B, Hkv, S, Dh] int8
  k_s, v_s  [B, Hkv, 1, S] f32      one scale per (slot, head, row)
  positions [B] int32               rows ``s <= min(position, S - 1)`` are live

Query head ``h`` reads KV head ``h // G`` (G = Hq / Hkv). The scales fold
in after the integer dots: a score is ``dot(q, k_int) * k_scale / sqrt(Dh)``
and P.V sums ``p * v_scale * v_int``.

- :func:`decode_attention`: on CUDA tensors it launches
  ``csrc/decode_attention.cu`` (each strip split across blocks of
  ``SPLIT_ROWS`` rows, online f32 softmax over the slot's live rows only,
  the splits merged by log-sum-exp); on CPU tensors it runs
  :func:`decode_attention_plain`.
- :func:`split_plan`: how many blocks share a strip, from ``S`` alone.
- :func:`decode_attention_xla`: the model's non-kernel read, JAX's
  dequantize-then-einsum formula over the first ``window`` rows, for
  ``T`` query tokens per slot.
- :func:`supported`: the port's predicate for what the kernel serves. The
  engine refuses to build on CUDA when it says no.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from generativeaiexamples_tpu_torch.ops import _build

_NEG_INF = -1e30
# Head dims csrc/decode_attention.cu is instantiated for.
_HEAD_DIMS = (64, 128, 256)
# Rows of a strip one block of csrc/decode_attention.cu walks: a long strip
# is split across ceil(live rows / SPLIT_ROWS) blocks per KV head, merged
# afterwards.
SPLIT_ROWS = 512

_SIGNATURES = {
    "decode_attention_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}


def split_plan(S: int) -> tuple:
    """(rows per split, splits per strip) for strips of ``S`` rows: enough
    ``SPLIT_ROWS``-row splits to cover the whole strip. It reads only the
    cache's shape, never the positions, so the launch needs nothing from
    the device; blocks of splits past a slot's position return at once."""
    if S < 1:
        raise ValueError(f"split_plan: S={S} must be positive")
    return SPLIT_ROWS, -(-S // SPLIT_ROWS)


def workspace_elements(B: int, Hq: int, Dh: int, nsplit: int) -> int:
    """f32 values of the merge workspace: each split's (max, sum) and
    accumulator per (slot, query head); none when one split covers the
    strip (it writes the output directly)."""
    return 0 if nsplit == 1 else B * Hq * nsplit * (Dh + 2)


def decode_attention_plain(q, k_q, k_s, v_q, v_s, positions) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores of the integer
    rows with the K scale folded in after the dot, masked to each slot's
    live rows, f32 softmax, f32 P.V over the V-scaled probabilities, one
    rounding to q's dtype at the end; a slot with no live row gives 0."""
    B, Hq, Dh = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).float()
    sc = torch.einsum("bkgd,bksd->bkgs", qg, k_q.float())
    sc = sc * (k_s[:, :, 0, :].float() * (1.0 / math.sqrt(Dh)))[:, :, None, :]
    last = torch.clamp(positions.long(), max=S - 1)
    live = (torch.arange(S, device=q.device)[None, :] <= last[:, None])[:, None, None, :]
    sc = torch.where(live, sc, torch.full_like(sc, _NEG_INF))
    p = torch.where(live, torch.exp(sc - sc.amax(dim=-1, keepdim=True)), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    pv = p * v_s[:, :, 0, :].float()[:, :, None, :]
    out = torch.einsum("bkgs,bksd->bkgd", pv, v_q.float())
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, Hq, Dh).to(q.dtype)


def _launch(q, k_q, k_s, v_q, v_s, positions) -> torch.Tensor:
    if q.dim() != 3 or k_q.dim() != 4:
        raise ValueError(
            f"decode_attention: q must be [B, Hq, Dh] and the cache [B, Hkv, S, Dh], "
            f"got {tuple(q.shape)} and {tuple(k_q.shape)}"
        )
    B, Hq, Dh = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    if q.dtype != torch.bfloat16 or k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise ValueError(
            f"decode_attention: the CUDA kernel serves bf16 q over an int8 cache, got "
            f"q {q.dtype}, k {k_q.dtype}, v {v_q.dtype}"
        )
    if tuple(k_q.shape) != (B, Hkv, S, Dh) or v_q.shape != k_q.shape:
        raise ValueError(
            f"decode_attention: cache must be [{B}, Hkv, S, {Dh}] for both K and V, got "
            f"{tuple(k_q.shape)} and {tuple(v_q.shape)}"
        )
    if not supported(S, Dh, Hq, Hkv):
        raise ValueError(
            f"decode_attention: geometry S={S} Dh={Dh} Hq={Hq} Hkv={Hkv} is not served by "
            f"the CUDA kernel"
        )
    for s in (k_s, v_s):
        if s.dtype != torch.float32 or tuple(s.shape) != (B, Hkv, 1, S) or not s.is_contiguous():
            raise ValueError(
                f"decode_attention: scales must be contiguous f32 {(B, Hkv, 1, S)}, "
                f"got {s.dtype} {tuple(s.shape)}"
            )
    if not (k_q.is_contiguous() and v_q.is_contiguous()):
        raise ValueError("decode_attention: the cache must be contiguous")
    if tuple(positions.shape) != (B,) or positions.dtype != torch.int32:
        raise ValueError(
            f"decode_attention: positions must be int32 [{B}], got {positions.dtype} "
            f"{tuple(positions.shape)}"
        )
    devices = {t.device for t in (q, k_q, k_s, v_q, v_s, positions)}
    if len(devices) != 1:
        raise ValueError(f"decode_attention: all tensors must be on one device, got {devices}")
    if k_q.data_ptr() % 16 or v_q.data_ptr() % 16:
        raise ValueError("decode_attention: the cache must start on a 16-byte boundary")
    q = q.contiguous()
    positions = positions.contiguous()
    out = torch.empty_like(q)
    split_rows, nsplit = split_plan(S)
    n_ws = workspace_elements(B, Hq, Dh, nsplit)
    ws = tickets = None
    if n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
        # one ticket per (slot, KV head, group of 4 query heads)
        tickets = _build.tickets("decode_attention", q, B * Hkv * -(-(Hq // Hkv) // 4))
    lib = _build.load("decode_attention", _SIGNATURES)
    code = lib.decode_attention_launch(
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
        positions.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        B, Hq, Hkv, S, Dh, 1.0 / math.sqrt(Dh), split_rows, nsplit, _build.stream_ptr(q),
    )
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [B, Hq, Dh] bf16, one query token per slot
    k_q: torch.Tensor,  # [B, Hkv, S, Dh] int8
    k_s: torch.Tensor,  # [B, Hkv, 1, S] f32
    v_q: torch.Tensor,  # [B, Hkv, S, Dh] int8
    v_s: torch.Tensor,  # [B, Hkv, 1, S] f32
    positions: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Attention output ``[B, Hq, Dh]`` for one decode step per slot (the
    step's own row must already be in the cache)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_q, k_s, v_q, v_s, positions)
    return _launch(q, k_q, k_s, v_q, v_s, positions)


# launches of the CUDA kernel
decode_attention.launches = 0


def decode_attention_xla(
    q: torch.Tensor,  # [B, T, Hq, Dh]
    k_q: torch.Tensor,  # [B, Hkv, S, Dh] int8
    k_s: torch.Tensor,  # [B, Hkv, 1, S] f32
    v_q: torch.Tensor,
    v_s: torch.Tensor,
    positions: torch.Tensor,  # [B, T]
    window: Optional[int] = None,
) -> torch.Tensor:
    """The non-kernel read over the same cache: the first ``W`` rows
    dequantized to f32, f32 einsums and softmax, one rounding to q's dtype.
    ``window`` must cover ``max(positions) + 1``: only the first ``W`` rows
    are read, so an undersized window drops the newest context."""
    B, T, Hq, Dh = q.shape
    Hkv, S = k_q.shape[1], k_q.shape[2]
    W = min(window or S, S)
    k = k_q[:, :, :W].float() * k_s[:, :, 0, :W, None]  # [B, Hkv, W, Dh]
    v = v_q[:, :, :W].float() * v_s[:, :, 0, :W, None]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, Dh).float()
    sc = torch.einsum("btkgd,bksd->bkgts", qg, k) / math.sqrt(Dh)
    mask = torch.arange(W, device=q.device)[None, None, :] <= positions.long()[:, :, None]
    sc = torch.where(mask[:, None, None], sc, torch.full_like(sc, _NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgts,bksd->btkgd", p, v)
    return out.reshape(B, T, Hq, Dh).to(q.dtype)


def supported(S: int, head_dim: int, num_heads: int, num_kv_heads: int) -> bool:
    """Whether the CUDA kernel serves this cache geometry: the JAX
    predicate's structural half (GQA divisibility) plus what
    ``csrc/decode_attention.cu`` needs (a positive capacity and a head dim
    it is instantiated for). The TPU's lane and sublane tiling rules (head
    dim a multiple of 128, S a multiple of 32 and of the block, Hq a
    multiple of 8) do not apply on the GPU."""
    return (
        S >= 1
        and num_kv_heads >= 1
        and num_heads % num_kv_heads == 0
        and head_dim in _HEAD_DIMS
    )
