"""Engine configuration for the port.

The fields of the JAX package's ``EngineConfig``
(generativeaiexamples_tpu/config/schema.py) that the port serves, with the
same names and defaults. A value the port does not serve raises in
:meth:`EngineConfig.validate` instead of being ignored.
:meth:`EngineConfig.from_env` reads the JAX package's environment names
for these fields (``APP_ENGINE_QUANTIZATION``, ``APP_ENGINE_KVCACHEDTYPE``,
…): ``APP_ENGINE_`` and the field name without underscores, upper-cased.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

ENV_PREFIX = "APP_ENGINE_"


@dataclasses.dataclass
class EngineConfig:
    model_config_name: str = "llama3-8b"
    # HF tokenizer.json; empty uses the byte-level tokenizer
    tokenizer_path: str = ""
    dtype: str = "bfloat16"
    # none | int8 (weight-only) | w8a8 (int8 weights, per-token int8 activations)
    quantization: str = "none"
    # bfloat16 | int8 | int4 paged KV pool
    kv_cache_dtype: str = "bfloat16"
    max_batch_size: int = 8
    max_seq_len: int = 8192
    # auto | paged | fixed: auto pages wherever the page geometry tiles
    # (engine/kv_pages.auto_layout_blockers) and logs why it serves fixed
    # otherwise; fixed keeps one dense max_seq_len strip per slot
    kv_layout: str = "auto"
    page_size: int = 128
    # device page-pool size; 0 = one full-capacity strip per slot + scratch
    kv_pool_pages: int = 0
    prefill_chunk: int = 512
    # decode steps per dispatch; one device-to-host readback per block
    decode_block: int = 8
    # stall deadline (s) for a consumer waiting on its next token
    stream_timeout_s: float = 600.0

    @classmethod
    def env_name(cls, field: str) -> str:
        """The JAX config's environment name of a field."""
        return ENV_PREFIX + field.replace("_", "").upper()

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "EngineConfig":
        """Defaults overridden by the ``APP_ENGINE_*`` variables that are
        set; a value that does not parse as the field's type raises."""
        environ = os.environ if environ is None else environ
        kwargs = {}
        for f in dataclasses.fields(cls):
            raw = environ.get(cls.env_name(f.name))
            if raw is None:
                continue
            typ = type(f.default)
            try:
                kwargs[f.name] = typ(raw)
            except ValueError:
                raise ValueError(
                    f"{cls.env_name(f.name)}={raw!r} is not a valid {typ.__name__}"
                ) from None
        return cls(**kwargs)

    def validate(self) -> None:
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {self.dtype!r}")
        if self.quantization not in ("none", "int8", "w8a8"):
            raise ValueError(
                f"quantization must be 'none', 'int8' or 'w8a8', got {self.quantization!r}"
            )
        if self.kv_cache_dtype not in ("bfloat16", "int8", "int4"):
            raise ValueError(
                f"kv_cache_dtype must be 'bfloat16', 'int8', or 'int4', "
                f"got {self.kv_cache_dtype!r}"
            )
        if self.kv_layout not in ("auto", "paged", "fixed"):
            raise ValueError(
                f"kv_layout must be 'auto', 'paged' or 'fixed', got {self.kv_layout!r}"
            )
        if self.prefill_chunk <= 0:
            raise ValueError(f"prefill_chunk must be > 0, got {self.prefill_chunk}")
        p = self.page_size
        if self.kv_layout == "paged":  # auto falls back to fixed instead
            if p <= 0 or p & (p - 1) or p > 128:
                raise ValueError(f"page_size must be a power of two <= 128, got {p}")
            if self.prefill_chunk % p:
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
