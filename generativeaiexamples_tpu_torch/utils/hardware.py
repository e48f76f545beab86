"""Peak rates of the card and the roofline arithmetic, in one place.

Counterpart of generativeaiexamples_tpu/utils/hardware.py: the same byte
and FLOP formulas, with the peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense, at the 700 W power limit) in place of the TPU's. A card set
to a lower power limit runs below these peaks; callers print the limit
beside every ratio.

The ``*_cost`` helpers give each kernel's least work for one call — every
input read once, every output written once, the operations its inputs
need — and :func:`bound_ms` turns that into the least time the card could
take.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

PEAK_TFLOPS = 989.0  # bf16 / fp16 dense tensor-core rate
PEAK_INT8_TOPS = 1979.0  # int8 dense tensor-core rate
PEAK_HBM_GBPS = 3350.0  # HBM3 bandwidth


def matmul_params(model_cfg) -> int:
    """Parameters that hit a matmul per generated token: every logical
    parameter except the embedding table (a gather at decode)."""
    from generativeaiexamples_tpu_torch.models.llama import count_logical_params

    return count_logical_params(model_cfg) - model_cfg.vocab_size * model_cfg.hidden_size


def mfu_ratio(tokens_per_sec: float, n_matmul_params: int, devices: int = 1) -> float:
    """Model FLOPs utilization: ~2 FLOPs per matmul parameter per token."""
    return tokens_per_sec * 2.0 * n_matmul_params / (PEAK_TFLOPS * 1e12 * max(1, devices))


def hbm_ratio(bytes_per_sec: float, devices: int = 1) -> float:
    """Achieved memory bandwidth as a fraction of the peak."""
    return bytes_per_sec / (PEAK_HBM_GBPS * 1e9 * max(1, devices))


_KV_BYTES_PER_ELEMENT = {"bfloat16": 2.0, "int8": 1.0, "int4": 0.5}


def mesh_peaks(devices: int = 1) -> Dict[str, float]:
    """The peak rates of ``devices`` distinct cards together (shards that
    share one card share its peaks)."""
    n = max(1, int(devices))
    return {"devices": n, "peak_tflops": PEAK_TFLOPS * n, "peak_int8_tops": PEAK_INT8_TOPS * n,
            "peak_hbm_gbps": PEAK_HBM_GBPS * n}


def device_memory(devices) -> Dict[str, Dict[str, int]]:
    """Each distinct device's memory: the card's total, and PyTorch's
    allocated and peak-allocated bytes there (0 on the CPU, which reports
    none)."""
    import torch

    out: Dict[str, Dict[str, int]] = {}
    for dev in devices:
        dev = torch.device(dev)
        if str(dev) in out:
            continue
        if dev.type == "cuda":
            out[str(dev)] = {
                "total_bytes": int(torch.cuda.get_device_properties(dev).total_memory),
                "allocated_bytes": int(torch.cuda.memory_allocated(dev)),
                "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(dev)),
            }
        else:
            out[str(dev)] = {"total_bytes": 0, "allocated_bytes": 0, "peak_allocated_bytes": 0}
    return out


def kv_bytes_per_element(kv_cache_dtype: str) -> float:
    """Per-element KV cache width in bytes for a configured dtype string."""
    try:
        return _KV_BYTES_PER_ELEMENT[kv_cache_dtype]
    except KeyError:
        raise ValueError(
            f"unknown kv_cache_dtype {kv_cache_dtype!r}; expected one of "
            f"{sorted(_KV_BYTES_PER_ELEMENT)}"
        ) from None


def kv_read_bytes_per_step(model_cfg, batch: int, window: int, kv_bytes: float) -> int:
    """Attention cache traffic for one decode step over the whole batch,
    when every row reads ``window`` rows of K and V per layer."""
    return int(
        2 * batch * window * model_cfg.num_kv_heads * model_cfg.head_dim
        * kv_bytes * model_cfg.num_layers
    )


def kv_read_bytes_ragged(model_cfg, live_tokens: int, kv_bytes: float) -> int:
    """Attention cache traffic for one ragged decode step: only the live
    K and V rows, summed over the batch as ``live_tokens``."""
    return kv_read_bytes_per_step(model_cfg, 1, live_tokens, kv_bytes)


def streamed_weight_bytes(params) -> int:
    """Bytes a decode step streams for weights: every parameter tensor
    except the embedding table (gathered rows only)."""

    def walk(tree):
        if isinstance(tree, dict):
            for key, val in tree.items():
                if key != "embed":
                    yield from walk(val)
        elif isinstance(tree, (list, tuple)):
            for val in tree:
                yield from walk(val)
        else:
            yield tree

    return sum(int(t.numel() * t.element_size()) for t in walk(params))


def bound_ms(nbytes: float, flops: float, int8: bool = False) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the bf16 rate, or
    over the int8 rate for ``int8`` (integer) work."""
    t_bytes = nbytes / (PEAK_HBM_GBPS * 1e9)
    t_ops = flops / ((PEAK_INT8_TOPS if int8 else PEAK_TFLOPS) * 1e12)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def int8_matmul_cost(M: int, K: int, F: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of y[M, F] = (x[M, K] @ q[K, F]) * scale: bf16 x,
    int8 weight and f32 scale read once, bf16 y written once."""
    return M * K * 2 + K * F + F * 4 + M * F * 2, 2 * M * K * F


def w8a8_matmul_cost(M: int, K: int, F: int, x_bytes: int = 2) -> Tuple[int, int]:
    """(bytes, integer operations) of the W8A8 product at the API
    (``int8_w8a8_matmul``, its quantizer included): x (``x_bytes`` an
    element: 2 bf16, 4 f32), the int8 weight and the f32 scale read once,
    bf16 y written once, and the weight-only product's operations, which
    :func:`bound_ms` counts at the int8 rate."""
    nbytes, ops = int8_matmul_cost(M, K, F)
    return nbytes + M * K * (x_bytes - 2), ops


def paged_attention_cost(
    q_positions, Hq: int, Hkv: int, Dh: int, Pmax: int,
    kv_bytes: float = 2.0, scale_bytes: int = 0,
) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ragged page-attention call whose rows query
    the positions listed per row (``q_positions``: one list of query
    positions per row). Each row reads its K and V rows up to its last
    query position once, ``kv_bytes`` per element (2 bf16, 1 int8, 0.5
    int4) plus ``scale_bytes`` per (token, KV head) for each of the two
    scale planes of a quantized pool (4 for f32 scales); each query head
    scores and sums over the positions at or before it."""
    nbytes = 0
    flops = 0
    for row in q_positions:
        T = len(row)
        live = (max(row) + 1) * Hkv
        nbytes += 2 * T * Hq * Dh * 2  # q read, out written
        nbytes += int(2 * live * (Dh * kv_bytes + scale_bytes))  # live K and V rows, scales
        nbytes += Pmax * 4 + 4  # table row, position
        flops += sum(4 * Dh * Hq * (p + 1) for p in row)
    return nbytes, flops


def flash_attention_cost(B: int, T: int, Hq: int, Hkv: int, D: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of causal prefill attention: q, k, v read once, out
    written once, 4 * D FLOPs per (query, key <= query, head)."""
    nbytes = 2 * B * T * D * (2 * Hq + 2 * Hkv)
    flops = 4 * B * Hq * D * (T * (T + 1) // 2)
    return nbytes, flops


def decode_attention_cost(
    positions, Hq: int, Hkv: int, Dh: int, kv_bytes: float = 1.0, scale_bytes: int = 4,
    S: Optional[int] = None,
) -> Tuple[int, int]:
    """(bytes, FLOPs) of one fixed-layout decode-attention call: one query
    token per slot at ``positions`` (one int per slot). Each slot reads its
    K and V rows up to its position (clamped to ``S - 1`` when the cache
    capacity ``S`` is given) once, ``kv_bytes`` per element plus
    ``scale_bytes`` per (row, KV head) for each of the two scale planes;
    the bf16 q is read and the bf16 out written once; each query head
    scores and sums over the live rows."""
    nbytes = 0
    flops = 0
    for p in positions:
        last = int(p) if S is None else min(int(p), S - 1)
        live = max(last + 1, 0)
        nbytes += 2 * Hq * Dh * 2  # q read, out written
        nbytes += int(2 * live * Hkv * (Dh * kv_bytes + scale_bytes))  # live K and V rows, scales
        nbytes += 4  # position
        flops += 4 * Dh * Hq * live
    return nbytes, flops


def encoder_flops(bert_cfg, rows: int, T: int) -> int:
    """FLOPs of one BERT encoder dispatch of ``rows`` x ``T`` positions
    (padding included: what the card computes): 2 per matmul parameter per
    position (``models/bert.matmul_params``), plus the attention's
    4 * T * hidden per position and layer (QKᵀ and P·V)."""
    from generativeaiexamples_tpu_torch.models.bert import matmul_params

    positions = rows * T
    return 2 * matmul_params(bert_cfg) * positions + 4 * bert_cfg.num_layers * positions * T * (
        bert_cfg.hidden_size)


def search_cost(rows: int, capacity: int, D: int, nlist: int = 0) -> Tuple[int, int]:
    """(bytes, FLOPs) of one top-k search dispatch over a padded f32
    corpus [capacity, D]: the corpus and the queries read once, the scores
    formed (2 * D FLOPs each; IVF adds the centroid scores). The top-k and
    its output are left out (a few KB)."""
    nbytes = 4 * D * (capacity + rows + nlist) + capacity  # + the valid mask
    flops = 2 * D * rows * (capacity + nlist)
    return nbytes, flops
