"""Engine configuration for the port.

The fields of the JAX package's ``EngineConfig``
(generativeaiexamples_tpu/config/schema.py) that the serving slice reads,
with the same names and defaults. A value the slice does not serve raises
in :meth:`EngineConfig.validate` instead of being ignored.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EngineConfig:
    model_config_name: str = "llama3-8b"
    # HF tokenizer.json; empty uses the byte-level tokenizer
    tokenizer_path: str = ""
    dtype: str = "bfloat16"
    # none | int8 (weight-only)
    quantization: str = "none"
    # bfloat16 only in this slice
    kv_cache_dtype: str = "bfloat16"
    max_batch_size: int = 8
    max_seq_len: int = 8192
    page_size: int = 128
    # device page-pool size; 0 = one full-capacity strip per slot + scratch
    kv_pool_pages: int = 0
    prefill_chunk: int = 512
    # decode steps per dispatch; one device-to-host readback per block
    decode_block: int = 8
    # stall deadline (s) for a consumer waiting on its next token
    stream_timeout_s: float = 600.0

    def validate(self) -> None:
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}")
        if self.quantization not in ("none", "int8"):
            raise ValueError(
                f"quantization {self.quantization!r} is not served by the PyTorch port "
                "(none | int8; w8a8 is not ported yet)"
            )
        if self.kv_cache_dtype != "bfloat16":
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r} is not served by the PyTorch port "
                "(bfloat16 only; the int8 and int4 page pools are not ported yet)"
            )
        p = self.page_size
        if p <= 0 or p & (p - 1) or p > 128:
            raise ValueError(f"page_size must be a power of two <= 128, got {p}")
        if self.prefill_chunk <= 0 or self.prefill_chunk % p:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must be a positive multiple of "
                f"page_size ({p})"
            )
        if self.max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {self.max_batch_size}")
        if self.decode_block < 1:
            raise ValueError(f"decode_block must be >= 1, got {self.decode_block}")
        if self.kv_pool_pages < 0:
            raise ValueError(f"kv_pool_pages must be >= 0, got {self.kv_pool_pages}")
        if self.stream_timeout_s <= 0:
            raise ValueError(f"stream_timeout_s must be > 0, got {self.stream_timeout_s}")
