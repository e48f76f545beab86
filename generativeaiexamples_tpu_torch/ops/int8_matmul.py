"""bf16 activations x int8 weights, weight-streaming (W8A16).

Counterpart of generativeaiexamples_tpu/ops/int8_matmul.py. Same packed
layout, so packs cross packages unchanged:

    {"q": int8 [K_pad, F_pad], "scale": float32 [1, F]}

with K padded to ``K_ALIGN`` and F to ``F_BLK`` (zero padding), and

    y[M, F] = (x[M, K] @ bf16(q[K, F])) * scale[1, F]

- :func:`int8_matmul` is the decode kernel (M <= ``M_MAX`` rows): on a CUDA
  tensor it launches ``csrc/int8_matmul.cu`` (weights stream once, int8 ->
  float in registers, f32 sum, scale after the sum); on a CPU tensor it runs
  :func:`int8_matmul_plain`, the same formula in plain PyTorch.
- :func:`int8_matmul_dequant` is the large-M (prefill) path, as the JAX
  package's ``int8_matmul_xla``: bf16 weights dequantized once per call and
  one ``torch.matmul``.
- :func:`packed_matmul` dispatches between the two by M.
"""
from __future__ import annotations

import ctypes

import torch

from generativeaiexamples_tpu_torch.ops import _build

F_BLK = 512
K_ALIGN = 128
M_MAX = 128
# csrc/int8_matmul.cu: K rows one split stages in shared memory, and the
# number of blocks the split-K grid aims for (two per H100 SM).
_MAX_K_CHUNK = 512
_TARGET_BLOCKS = 264

_SIGNATURES = {
    "int8_matmul_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
}


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's formula in plain PyTorch: f32 products of the bf16
    activation and the int8 weight, f32 sum, scale applied after the sum,
    one bf16 rounding at the end. Not the dequant path's formula, which
    rounds the scaled weight to bf16 before the product."""
    K = x.shape[-1]
    F = scale.shape[-1]
    y = x.to(torch.bfloat16).float() @ q[:K, :F].float()
    return (y * scale.float().reshape(F)).to(torch.bfloat16)


def _split_k(K: int, n_tiles: int):
    """(splits, k_chunk) for the split-K grid: enough blocks to fill the
    card at M = 1, each split at most ``_MAX_K_CHUNK`` rows of K."""
    splits = max(1, min(-(-_TARGET_BLOCKS // n_tiles), -(-K // 64)))
    k_chunk = -(-K // splits)
    if k_chunk > _MAX_K_CHUNK:
        k_chunk = _MAX_K_CHUNK
    k_chunk = -(-k_chunk // 32) * 32  # whole rounds of the kernel's 8 loads x 4 K groups
    return -(-K // k_chunk), k_chunk


def _launch(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    M, K = x2.shape
    K_pad, F_pad = q.shape
    F = scale.shape[-1]
    if q.dtype != torch.int8 or not q.is_contiguous() or F_pad % F_BLK or K > K_pad:
        raise ValueError(
            f"int8_matmul: q must be a contiguous int8 pack [K_pad, F_pad % {F_BLK}] "
            f"with K_pad >= K={K}, got {tuple(q.shape)} {q.dtype}"
        )
    if q.device != x2.device or scale.device != x2.device:
        raise ValueError("int8_matmul: x, q and scale must share one device")
    splits, k_chunk = _split_k(K, F_pad // F_BLK)
    s = scale.reshape(F).to(torch.float32).contiguous()
    ws = torch.empty((splits, M, F_pad), dtype=torch.float32, device=x2.device)
    y = torch.empty((M, F), dtype=torch.bfloat16, device=x2.device)
    lib = _build.load("int8_matmul", _SIGNATURES)
    code = lib.int8_matmul_launch(
        x2.data_ptr(), M, K, q.data_ptr(), F_pad, s.data_ptr(), F,
        ws.data_ptr(), splits, k_chunk, y.data_ptr(), _build.stream_ptr(x2),
    )
    _build.check(code, "int8_matmul")
    int8_matmul.launches += 1
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ dequant(q))[..., :F] for M = prod(leading dims) <= M_MAX;
    leading dims preserved. CUDA tensors launch the kernel; CPU tensors run
    :func:`int8_matmul_plain`."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    F = scale.shape[-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    M = x2.shape[0]
    if M > M_MAX:
        raise ValueError(
            f"int8_matmul serves decode-shaped calls only (M={M} > {M_MAX}); "
            "use int8_matmul_dequant (or packed_matmul, which dispatches by M)."
        )
    if x2.device.type == "cpu":
        y = int8_matmul_plain(x2, q, scale)
    else:
        y = _launch(x2.contiguous(), q, scale)
    return y.reshape(*lead, F)


int8_matmul.launches = 0


def int8_matmul_dequant(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Large-M path (prefill): dequantize to bf16, then one matmul —
    ``int8_matmul_xla``'s formula, which the JAX package also runs outside
    any Pallas kernel."""
    K = x.shape[-1]
    F = scale.shape[-1]
    w = (q[:K, :F].float() * scale.float()).to(torch.bfloat16)
    return x.to(torch.bfloat16) @ w


def kernel_supported(q: torch.Tensor) -> bool:
    """Whether the kernel serves this packed weight's shapes."""
    return q.dim() == 2 and q.dtype == torch.int8 and q.shape[1] % F_BLK == 0


def packed_matmul(x: torch.Tensor, packed, use_kernel: bool = True) -> torch.Tensor:
    """x @ packed int8 weight. Decode-shaped calls (M <= M_MAX) take
    :func:`int8_matmul` (``use_kernel=False`` runs its plain version instead,
    on any device); larger M takes :func:`int8_matmul_dequant`."""
    M = x.numel() // x.shape[-1]
    if M <= M_MAX:
        if use_kernel:
            return int8_matmul(x, packed["q"], packed["scale"])
        lead = x.shape[:-1]
        y = int8_matmul_plain(x.reshape(-1, x.shape[-1]), packed["q"], packed["scale"])
        return y.reshape(*lead, y.shape[-1])
    return int8_matmul_dequant(x, packed["q"], packed["scale"])
