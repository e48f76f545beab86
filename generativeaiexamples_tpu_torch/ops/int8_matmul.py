"""int8 weight matmuls for serving: weight-only (W8A16) and W8A8.

Counterpart of generativeaiexamples_tpu/ops/int8_matmul.py. Same packed
layout, so packs cross packages unchanged:

    {"q": int8 [K_pad, F_pad], "scale": float32 [1, F]}

with K padded to ``K_ALIGN`` and F to ``F_BLK`` (zero padding).

Weight-only, ``y[M, F] = (x[M, K] @ bf16(q[K, F])) * scale[1, F]``:
- :func:`int8_matmul` is the decode kernel (M <= ``M_MAX`` rows): on a CUDA
  tensor it launches ``csrc/int8_matmul.cu`` (weights stream once as
  16-byte loads, int8 -> bf16 in registers, ``mma.sync`` on the tensor
  cores with an f32 sum, scale after the sum; K split across blocks only as
  far as :func:`mma_plan` says the card needs); on a CPU tensor it runs
  :func:`int8_matmul_plain`, the same formula in plain PyTorch.
- :func:`int8_matmul_dequant` is the large-M (prefill) path, as the JAX
  package's ``int8_matmul_xla``: bf16 weights dequantized once per call and
  one ``torch.matmul``.

W8A8, per-token int8 activations (:func:`quantize_rows`) and an exact
int32 sum, ``y = bf16((f32(xq @ q) * sx) * scale)``:
- :func:`int8_w8a8_matmul` is the decode kernel: on a CUDA tensor it
  launches ``csrc/int8_w8a8_matmul.cu`` once, with the quantizer inside
  (bf16 or f32 x in, int8 tensor cores, split-K as :func:`w8a8_plan` says,
  summed by the last block; from ``W8A8_TWO_LAUNCH_K`` the quantizer is a
  launch of its own); on a CPU tensor it runs
  :func:`int8_w8a8_matmul_plain`. Both sums are exact and both quantizers
  are the same f32 arithmetic, so the two agree bit for bit.
- :func:`int8_matmul_w8a8_prefill` is the large-M path, as the JAX
  package's ``int8_matmul_xla_w8a8``: ``torch._int_mm`` (exact int32) over
  output-column chunks.

:func:`packed_matmul` dispatches by M and by mode.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from generativeaiexamples_tpu_torch.ops import _build

F_BLK = 512
K_ALIGN = 128
M_MAX = 128
# The number of blocks a split-K grid aims for (two per H100 SM).
_TARGET_BLOCKS = 264
# csrc/int8_matmul.cu and csrc/int8_w8a8_matmul.cu: columns of F one block
# owns, and the K rows one round of its 8 warps covers (8 mma steps of 16
# for int8_matmul, of 32 for W8A8): a split is whole rounds.
_MMA_TILE_F = 128
_MMA_K_ROUND = 128
_W8A8_K_ROUND = 256
# K from which int8_w8a8_matmul runs its quantizer as a launch of its own
# (the kernel file's two-launch variant) instead of inside every block of
# the product: there every block would read M x K of x to find the row
# scales. On the H100 (kernel_sweep.py, PERF.md) w_down (K = 14336) at
# M = 8 took 0.0418 ms in two launches against 0.0457 in one; every K of
# 4096 kept one launch.
W8A8_TWO_LAUNCH_K = 4097

_SIGNATURES = {
    "int8_matmul_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ],
}
_W8A8_SIGNATURES = {
    "int8_w8a8_matmul_launch": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
}
W8A8_DTYPES = (torch.bfloat16, torch.float32)
# Elements of the int32 product one _int_mm call of the prefill path may
# hold, as the JAX package's int8_matmul_xla_w8a8 chunks its output axis.
_MAX_ACC_ELEMS = 64 * 1024 * 1024


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The kernel's formula in plain PyTorch: f32 products of the bf16
    activation and the int8 weight, f32 sum, scale applied after the sum,
    one bf16 rounding at the end. Not the dequant path's formula, which
    rounds the scaled weight to bf16 before the product."""
    K = x.shape[-1]
    F = scale.shape[-1]
    y = x.to(torch.bfloat16).float() @ q[:K, :F].float()
    return (y * scale.float().reshape(F)).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def mma_plan(K: int, F_pad: int, k_round: int = _MMA_K_ROUND):
    """(splits, k_chunk) of a grid of ``F_pad / 128`` column tiles x
    ``splits`` (``csrc/int8_matmul.cu``; ``csrc/int8_w8a8_matmul.cu``
    through :func:`w8a8_plan`): as many splits as keep the grid within
    ``_TARGET_BLOCKS`` (two blocks an SM: one wave), each a whole number of
    ``k_round``-row rounds of the block's 8 warps; one split where the
    column tiles alone come to more than half of that (w_gateup, the
    lm_head: their blocks then scale and write bf16 themselves, no
    partials). On the H100 a grid just past
    one wave lost to the largest grid inside it on every projection of
    llama3-8b."""
    n_tiles = F_pad // _MMA_TILE_F
    rounds = -(-K // k_round)
    splits = max(1, min(_TARGET_BLOCKS // n_tiles, rounds))
    k_chunk = -(-rounds // splits) * k_round
    return -(-K // k_chunk), k_chunk


def w8a8_plan(K: int, F_pad: int):
    """(splits, k_chunk) of ``csrc/int8_w8a8_matmul.cu``: :func:`mma_plan`
    with its 256-row rounds."""
    return mma_plan(K, F_pad, _W8A8_K_ROUND)


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
    if q.data_ptr() % 16:
        raise ValueError("int8_matmul: the pack must start on a 16-byte boundary")
    splits, k_chunk = mma_plan(K, F_pad)
    s = scale.reshape(F).to(torch.float32).contiguous()
    # split-K partials and one ticket per (pass of 8 or 16 rows, column
    # tile) for the block that sums them; one split writes y itself
    ws = tickets = None
    if splits > 1:
        ws = torch.empty((splits, M, F_pad), dtype=torch.float32, device=x2.device)
        passes = -(-M // (8 if M <= 8 else 16))
        tickets = _build.tickets("int8_matmul", x2, passes * (F_pad // _MMA_TILE_F))
    y = torch.empty((M, F), dtype=torch.bfloat16, device=x2.device)
    lib = _build.load("int8_matmul", _SIGNATURES)
    code = lib.int8_matmul_launch(
        x2.data_ptr(), M, K, q.data_ptr(), K_pad, F_pad, s.data_ptr(), F,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), splits, k_chunk, y.data_ptr(),
        _build.stream_ptr(x2),
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


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) symmetric absmax int8: [..., K] -> (int8
    [..., K], f32 scales [..., 1]). f32 math, round half to even: bitwise
    the JAX package's."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # divided by a tensor, not a Python number: PyTorch's CUDA division by
    # a host scalar multiplies by its reciprocal, one ulp off IEEE division
    # at times; this is IEEE on every device, as the kernel's __fdiv_rn
    s = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return q, s


def _scale_rows(acc: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The W8A8 epilogue in the reference's order: (f32(acc) * sx) * s,
    one bf16 rounding. ``acc`` holds exact integer sums."""
    return (acc.float() * sx * scale.float()).to(torch.bfloat16)


def int8_w8a8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The W8A8 kernel's function in plain PyTorch, x [M, K] -> bf16
    [M, F]: rows quantized by :func:`quantize_rows`, the integer product
    summed in float64 (exact: |sum| <= 127^2 * K < 2^53), then the
    epilogue. Output columns go in chunks so the float64 copy of the
    weight stays small."""
    K = x.shape[-1]
    F = scale.shape[-1]
    xq, sx = quantize_rows(x)
    xd = xq.double()
    chunk = max(F_BLK, _MAX_ACC_ELEMS // max(K, 1) // F_BLK * F_BLK)
    outs = []
    for f0 in range(0, F, chunk):
        f1 = min(f0 + chunk, F)
        acc = xd @ q[:K, f0:f1].double()
        outs.append(_scale_rows(acc, sx, scale.reshape(F)[f0:f1]))
    return torch.cat(outs, dim=-1)


def _launch_w8a8(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel (two at K >= ``W8A8_TWO_LAUNCH_K``) and no
    compute around it: y, the split-K partials and, for the two-launch
    variant, the quantized rows are ``torch.empty``."""
    M, K = x2.shape
    K_pad, F_pad = q.shape
    F = scale.shape[-1]
    if q.dtype != torch.int8 or not q.is_contiguous() or F_pad % F_BLK or K_pad % K_ALIGN or K > K_pad:
        raise ValueError(
            f"int8_w8a8_matmul: q must be a contiguous int8 pack [K_pad % {K_ALIGN}, "
            f"F_pad % {F_BLK}] with K_pad >= K={K}, got {tuple(q.shape)} {q.dtype}"
        )
    if scale.dtype != torch.float32 or not scale.is_contiguous() or scale.numel() != F:
        raise ValueError(f"int8_w8a8_matmul: scale must be contiguous float32 [1, F], got {scale.dtype}")
    if q.device != x2.device or scale.device != x2.device:
        raise ValueError("int8_w8a8_matmul: x, q and scale must share one device")
    if q.data_ptr() % 16:
        raise ValueError("int8_w8a8_matmul: the pack must start on a 16-byte boundary")
    splits, k_chunk = w8a8_plan(K, F_pad)
    dev = x2.device
    ws = tickets = xq = sx = None
    if splits > 1:
        ws = torch.empty((splits, M, F_pad), dtype=torch.int32, device=dev)
        passes = -(-M // (8 if M <= 8 else 16))
        tickets = _build.tickets("int8_w8a8_matmul", x2, passes * (F_pad // _MMA_TILE_F))
    if K >= W8A8_TWO_LAUNCH_K:
        xq = torch.empty((M, K_pad), dtype=torch.int8, device=dev)
        sx = torch.empty((M,), dtype=torch.float32, device=dev)
    y = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load("int8_w8a8_matmul", _W8A8_SIGNATURES)
    code = lib.int8_w8a8_matmul_launch(
        x2.data_ptr(), int(x2.dtype == torch.float32), M, K, q.data_ptr(), K_pad, F_pad,
        scale.data_ptr(), F, ptr(ws), ptr(tickets), splits, k_chunk, ptr(xq), ptr(sx),
        y.data_ptr(), _build.stream_ptr(x2),
    )
    _build.check(code, "int8_w8a8_matmul")
    int8_w8a8_matmul.launches += 1
    if xq is not None:
        int8_w8a8_matmul.quantize_launches += 1
    return y


def int8_w8a8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y ~= (x @ dequant(q))[..., :F] with per-token int8 activations, for
    M = prod(leading dims) <= M_MAX; leading dims preserved. CUDA tensors
    launch the kernel; CPU tensors run :func:`int8_w8a8_matmul_plain`.
    x is bf16 or float32 (quantized in f32 either way); any other dtype
    raises."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    F = scale.shape[-1]
    if x.dtype not in W8A8_DTYPES:
        raise ValueError(f"int8_w8a8_matmul takes bfloat16 or float32 x, got {x.dtype}")
    x2 = x.reshape(-1, K)
    if x2.shape[0] > M_MAX:
        raise ValueError(
            f"int8_w8a8_matmul serves decode-shaped calls only (M={x2.shape[0]} > {M_MAX}); "
            "use int8_matmul_w8a8_prefill (or packed_matmul, which dispatches by M)."
        )
    if x2.device.type == "cpu":
        y = int8_w8a8_matmul_plain(x2, q, scale)
    else:
        y = _launch_w8a8(x2 if x2.is_contiguous() else x2.contiguous(), q, scale)
    return y.reshape(*lead, F)


int8_w8a8_matmul.launches = 0
# of those, the launches that ran the quantizer as a kernel of its own
int8_w8a8_matmul.quantize_launches = 0


def int8_matmul_w8a8_prefill(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Large-M W8A8 path (prefill), the JAX package's
    ``int8_matmul_xla_w8a8``: per-token int8 activations, then
    ``torch._int_mm`` (int8 x int8 -> exact int32) over the whole pack, in
    output-column chunks that keep the int32 product at most
    ``_MAX_ACC_ELEMS`` elements. Activations are zero-padded to K_pad (the
    pack's padding rows are zero) so ``_int_mm``'s multiple-of-8 rule
    holds; the output columns are cut back to F."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    F = scale.shape[-1]
    K_pad, F_pad = q.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    xq, sx = quantize_rows(x2)
    xq_pad = torch.zeros((M, K_pad), dtype=torch.int8, device=x.device)
    xq_pad[:, :K] = xq
    s = scale.reshape(F)
    chunk = max(F_BLK, _MAX_ACC_ELEMS // max(M, 1) // F_BLK * F_BLK)
    if F_pad <= chunk:
        y = _scale_rows(torch._int_mm(xq_pad, q)[:, :F], sx, s)
    else:
        outs = []
        for f0 in range(0, F, chunk):
            f1 = min(f0 + chunk, F)
            w = q[:, f0:min(f0 + chunk, F_pad)].contiguous()  # column blocks are strided
            outs.append(_scale_rows(torch._int_mm(xq_pad, w)[:, : f1 - f0], sx, s[f0:f1]))
        y = torch.cat(outs, dim=-1)
    return y.reshape(*lead, F)


def kernel_supported(q: torch.Tensor) -> bool:
    """Whether the kernels serve this packed weight's shapes."""
    return q.dim() == 2 and q.dtype == torch.int8 and q.shape[1] % F_BLK == 0


PACKED_MODES = ("int8", "int8_plain", "w8a8", "w8a8_plain")


def packed_matmul(x: torch.Tensor, packed, mode: str = "int8") -> torch.Tensor:
    """x @ packed int8 weight. Decode-shaped calls (M <= M_MAX) take the
    mode's kernel, :func:`int8_matmul` (``"int8"``) or
    :func:`int8_w8a8_matmul` (``"w8a8"``), or its plain version on any
    device (``"int8_plain"``, ``"w8a8_plain"``); larger M takes
    :func:`int8_matmul_dequant` or, for the W8A8 modes,
    :func:`int8_matmul_w8a8_prefill`."""
    if mode not in PACKED_MODES:
        raise ValueError(f"packed_matmul mode must be one of {PACKED_MODES}, got {mode!r}")
    q, scale = packed["q"], packed["scale"]
    w8a8 = mode.startswith("w8a8")
    M = x.numel() // x.shape[-1]
    if M > M_MAX:
        return (int8_matmul_w8a8_prefill if w8a8 else int8_matmul_dequant)(x, q, scale)
    if mode == "int8":
        return int8_matmul(x, q, scale)
    if mode == "w8a8":
        return int8_w8a8_matmul(x, q, scale)
    plain = int8_w8a8_matmul_plain if w8a8 else int8_matmul_plain
    y = plain(x.reshape(-1, x.shape[-1]), q, scale)
    return y.reshape(*x.shape[:-1], y.shape[-1])
