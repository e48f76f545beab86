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

from typing import Tuple

PEAK_TFLOPS = 989.0  # bf16 / fp16 dense tensor-core rate
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


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the bf16 rate."""
    t_bytes = nbytes / (PEAK_HBM_GBPS * 1e9)
    t_ops = flops / (PEAK_TFLOPS * 1e12)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def int8_matmul_cost(M: int, K: int, F: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of y[M, F] = (x[M, K] @ q[K, F]) * scale: bf16 x,
    int8 weight and f32 scale read once, bf16 y written once."""
    return M * K * 2 + K * F + F * 4 + M * F * 2, 2 * M * K * F


def paged_attention_cost(
    q_positions, Hq: int, Hkv: int, Dh: int, Pmax: int
) -> Tuple[int, int]:
    """(bytes, FLOPs) of one ragged bf16 page-attention call whose rows
    query the positions listed per row (``q_positions``: one list of query
    positions per row). Each row reads its K and V rows up to its last
    query position once; each query head scores and sums over the
    positions at or before it."""
    nbytes = 0
    flops = 0
    for row in q_positions:
        T = len(row)
        nbytes += 2 * T * Hq * Dh * 2  # q read, out written
        nbytes += 2 * (max(row) + 1) * Hkv * Dh * 2  # live K and V rows
        nbytes += Pmax * 4 + 4  # table row, position
        flops += sum(4 * Dh * Hq * (p + 1) for p in row)
    return nbytes, flops


def flash_attention_cost(B: int, T: int, Hq: int, Hkv: int, D: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of causal prefill attention: q, k, v read once, out
    written once, 4 * D FLOPs per (query, key <= query, head)."""
    nbytes = 2 * B * T * D * (2 * Hq + 2 * Hkv)
    flops = 4 * B * Hq * D * (T * (T + 1) // 2)
    return nbytes, flops
