"""Causal GQA flash attention for the prefill path.

Counterpart of generativeaiexamples_tpu/ops/flash_attention.py:
``out[b, t, h] = softmax_{s <= t}(q[b, t, h] . k[b, s, h // group] /
sqrt(D)) @ v``, f32 running max and sum, the T x T scores never in device
memory.

- :func:`flash_attention_causal`: on CUDA tensors it launches
  ``csrc/flash_attention.cu``; on CPU tensors it runs
  :func:`flash_attention_plain`.
- :func:`supported` / :func:`preferred`: the same policy as the JAX
  package, with the same crossover (T >= 512): short prompts take the plain
  einsum attention in models/llama.py.
"""
from __future__ import annotations

import ctypes
import math

import torch

from generativeaiexamples_tpu_torch.ops import _build

# Prefill lengths from which the kernel serves (the JAX package's default).
MIN_T = 512
# Head dims csrc/flash_attention.cu is instantiated for.
_HEAD_DIMS = (64, 128)

_SIGNATURES = {
    "flash_attention_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ],
}


def flash_attention_plain(q, k, v) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 scores, causal mask,
    f32 softmax and P.V, one rounding to the input dtype at the end."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    sc = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    sc = torch.where(causal, sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _launch(q, k, v) -> torch.Tensor:
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if not supported(T, D) or Hq % Hkv:
        raise ValueError(
            f"flash_attention_causal: T={T} D={D} Hq={Hq} Hkv={Hkv} is not served "
            "by the CUDA kernel"
        )
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("flash_attention_causal: the CUDA kernel serves bf16 only")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, Hq, Hkv,
        D, 1.0 / math.sqrt(D), _build.stream_ptr(q),
    )
    _build.check(code, "flash_attention_causal")
    flash_attention_causal.launches += 1
    return out


def flash_attention_causal(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,  # [B, T, Hkv, D]
) -> torch.Tensor:
    """Causal self-attention over T new tokens; returns [B, T, Hq, D]."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    return _launch(q, k, v)


flash_attention_causal.launches = 0


def supported(T: int, D: int) -> bool:
    """True when the CUDA kernel serves this shape (an instantiated head
    dim, at least two tokens)."""
    return D in _HEAD_DIMS and T >= 2


def preferred(T: int, D: int, device: torch.device) -> bool:
    """Whether the flash kernel should serve this prefill shape: on the
    card, capable, and long enough (T >= MIN_T) that the T x T scores of
    the einsum path would cost more than the kernel's per-block overhead.
    The JAX package's rule, with the card in place of the TPU."""
    return torch.device(device).type == "cuda" and supported(T, D) and T >= MIN_T
