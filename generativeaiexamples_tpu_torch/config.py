"""Engine configuration for the port.

The fields of the JAX package's ``EngineConfig``
(generativeaiexamples_tpu/config/schema.py) that the port serves, with the
same names and defaults. A value the port does not serve raises in
:meth:`EngineConfig.validate` instead of being ignored.
:meth:`EngineConfig.from_env` reads the JAX package's environment names
for these fields (``APP_ENGINE_QUANTIZATION``, ``APP_ENGINE_KVCACHEDTYPE``,
…): ``APP_ENGINE_`` and the field name without underscores, upper-cased.
It knows the names of the JAX config's other engine fields too
(``JAX_ONLY_FIELDS``): one set to a value the port does not serve raises,
naming the ROADMAP item that will serve it; one that exists only for XLA's
compiles is logged once and ignored.

The retrieval side reads four more sections of the JAX config with its
names and defaults (``EmbeddingConfig``, ``RankingConfig``,
``BatchingConfig``, ``VectorStoreConfig``), each from
``APP_<SECTION>_<FIELD>`` as the JAX config wizard names them
(``vector_store.persist_dir`` -> ``APP_VECTORSTORE_PERSISTDIR``);
``AppConfig.from_env`` reads the engine and all four.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Mapping, Optional

logger = logging.getLogger(__name__)

ENV_PREFIX = "APP_ENGINE_"

_CKPT = "checkpoints load with training and checkpoints (ROADMAP queue 1 item 10)"
_MULTI = "the port serves one card until multi-GPU (ROADMAP queue 1 item 9)"
_PREFIX = "the prefix cache arrives with ROADMAP queue 1 item 4"
_SPEC = "speculative decoding arrives with ROADMAP queue 1 item 5"
_DISAGG = "scheduler policies arrive with disaggregation (ROADMAP queue 1 item 8)"
_SNAP = "drain and snapshots arrive with disaggregation (ROADMAP queue 1 item 8)"
# The JAX package's EngineConfig fields (config/schema.py) that the port
# has no field for: name -> (the JAX default, why another value is refused,
# the other values the port serves as they are). A reason of None marks a
# field that exists only for XLA's compiles: logged once, ignored.
JAX_ONLY_FIELDS = {
    "checkpoint_path": ("", _CKPT, ()),
    "tensor_parallelism": (-1, _MULTI, (1,)),
    "pipeline_parallelism": (1, _MULTI, ()),
    "serving_layout": ("auto", None, ()),
    "paged_kernel": ("auto", "the port always reads a paged pool through its kernel on the card", ()),
    "warmup_prompt_lengths": ("", None, ()),
    "chunked_prefill": ("auto", "the port always chunks prompts longer than prefill_chunk", ()),
    "prefix_cache_enable": ("auto", _PREFIX, ("off",)),
    "prefix_cache_slots": (4, _PREFIX, ()),
    "spec_decode_enable": ("off", _SPEC, ()),
    "spec_pipeline_enable": ("on", _SPEC, ()),
    "spec_draft_len": (8, _SPEC, ()),
    "spec_ngram_max": (3, _SPEC, ()),
    "spec_proposer": ("lookup", _SPEC, ()),
    "spec_draft_model": ("", _SPEC, ()),
    "spec_draft_checkpoint_path": ("", _SPEC, ()),
    "spec_draft_model_len": (0, _SPEC, ()),
    "spec_draft_kv_dtype": ("bfloat16", _SPEC, ()),
    "spec_draft_min_acceptance": (0.0, _SPEC, ()),
    "spec_adaptive_k": ("off", _SPEC, ()),
    "spec_adaptive_k_min": (1, _SPEC, ()),
    "spec_adaptive_k_threshold": (0.5, _SPEC, ()),
    "quiesce_timeout_s": (600.0, None, ()),  # warmup's wait for decode to drain
    "drain_timeout_s": (30.0, _SNAP, ()),
    "snapshot_spool_dir": ("/tmp/genai_snapshots", _SNAP, ()),
    "snapshot_spool_max": (64, _SNAP, ()),
    "scheduler_policy": ("unified", _DISAGG, ()),
    "handoff_queue_depth": (0, _DISAGG, ()),
}
_LOGGED: set = set()  # XLA-only variables already logged by this process


def _parse(name: str, raw: str, default):
    typ = type(default)
    try:
        return typ(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a valid {typ.__name__}") from None


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
    # decode blocks (and prefill waves) dispatched ahead of the reader
    # thread's readback: the bound of the readback queue
    decode_runahead: int = 4
    # cap on rows x prefill bucket per admission wave
    prefill_wave_tokens: int = 16384
    # pending requests before submit raises EngineOverloaded; 0 = unbounded
    max_queued_requests: int = 0
    # stall deadline (s) for a consumer waiting on its next token
    stream_timeout_s: float = 600.0
    # the dispatch loop's watchdog: work outstanding and no progress for
    # this long marks the engine wedged; 0 disables it
    watchdog_stall_s: float = 300.0

    @classmethod
    def env_name(cls, field: str) -> str:
        """The JAX config's environment name of a field."""
        return ENV_PREFIX + field.replace("_", "").upper()

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "EngineConfig":
        """Defaults overridden by the ``APP_ENGINE_*`` variables that are
        set; a value that does not parse as the field's type raises. A
        variable of ``JAX_ONLY_FIELDS`` is accepted at its JAX default (or
        at a value the port serves as it is), logged and ignored when it
        exists only for XLA, and raises otherwise."""
        environ = os.environ if environ is None else environ
        kwargs = {}
        for f in dataclasses.fields(cls):
            name = cls.env_name(f.name)
            raw = environ.get(name)
            if raw is not None:
                kwargs[f.name] = _parse(name, raw, f.default)
        for field, (default, reason, served) in JAX_ONLY_FIELDS.items():
            name = cls.env_name(field)
            raw = environ.get(name)
            if raw is None:
                continue
            if reason is None:
                if name not in _LOGGED:
                    _LOGGED.add(name)
                    logger.info("%s=%r ignored: it exists only for XLA's compiles", name, raw)
                continue
            value = _parse(name, raw, default)
            if value != default and value not in served:
                raise ValueError(f"{name}={raw}: {reason}")
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
        if self.decode_runahead < 1:
            raise ValueError(f"decode_runahead must be >= 1, got {self.decode_runahead}")
        if self.prefill_wave_tokens <= 0:
            raise ValueError(f"prefill_wave_tokens must be > 0, got {self.prefill_wave_tokens}")
        if self.stream_timeout_s <= 0:
            raise ValueError(f"stream_timeout_s must be > 0, got {self.stream_timeout_s}")
        # the JAX engine's resilience checks, with its messages (the port has
        # no warmup, but keeps the JAX bound so one config serves both)
        if self.max_queued_requests < 0:
            raise ValueError(
                f"max_queued_requests must be >= 0 (0 = unbounded), got "
                f"{self.max_queued_requests}"
            )
        if 0 < self.max_queued_requests < self.max_batch_size:
            raise ValueError(
                f"max_queued_requests ({self.max_queued_requests}) must be >= "
                f"max_batch_size ({self.max_batch_size}) so warmup waves fit "
                f"the admission queue"
            )
        if self.watchdog_stall_s < 0:
            raise ValueError(
                f"watchdog_stall_s must be >= 0 (0 disables), got "
                f"{self.watchdog_stall_s}"
            )


# --------------------------------------------------------------------------- #
# The retrieval side's sections


def _env_name(section: str, field: str) -> str:
    """The JAX config wizard's environment name: ``APP_`` + the section and
    the field, each without underscores, upper-cased."""
    return f"APP_{section.replace('_', '').upper()}_{field.replace('_', '').upper()}"


def _section_from_env(cls, section: str, environ: Optional[Mapping[str, str]]):
    environ = os.environ if environ is None else environ
    kwargs = {}
    for f in dataclasses.fields(cls):
        name = _env_name(section, f.name)
        raw = environ.get(name)
        if raw is not None:
            kwargs[f.name] = _parse(name, raw, f.default)
    out = cls(**kwargs)
    if getattr(out, "checkpoint_path", ""):
        raise ValueError(f"{_env_name(section, 'checkpoint_path')}={out.checkpoint_path}: {_CKPT}")
    return out


@dataclasses.dataclass
class EmbeddingConfig:
    """The JAX config's ``embeddings`` section (``APP_EMBEDDINGS_*``)."""

    model_name: str = "snowflake/arctic-embed-l"
    # tpu (the in-process encoder; on the card in the port), openai|remote
    # (an OpenAI-compatible /v1/embeddings server), hash (no weights)
    model_engine: str = "tpu"
    dimensions: int = 1024
    server_url: str = ""
    checkpoint_path: str = ""
    query_cache_size: int = 256

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "EmbeddingConfig":
        return _section_from_env(cls, "embeddings", environ)


@dataclasses.dataclass
class RankingConfig:
    """The JAX config's ``ranking`` section (``APP_RANKING_*``)."""

    model_name: str = "arctic-embed-m"
    # '' (disabled), tpu (the in-process cross-encoder), overlap (lexical)
    model_engine: str = ""
    server_url: str = ""
    checkpoint_path: str = ""

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "RankingConfig":
        return _section_from_env(cls, "ranking", environ)


@dataclasses.dataclass
class BatchingConfig:
    """The JAX config's ``batching`` section (``APP_BATCHING_*``), checked
    by ``engine/batcher.validate_config``."""

    enable: str = "on"
    max_wait_ms: float = 4.0
    max_batch_embed: int = 32
    max_batch_rerank: int = 16
    ingest_decode_yield_ms: float = 50.0

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "BatchingConfig":
        return _section_from_env(cls, "batching", environ)


@dataclasses.dataclass
class VectorStoreConfig:
    """The JAX config's ``vector_store`` section (``APP_VECTORSTORE_*``)."""

    name: str = "tpu"
    nlist: int = 64
    nprobe: int = 16
    persist_dir: str = "/tmp-data/vectorstore"

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "VectorStoreConfig":
        return _section_from_env(cls, "vector_store", environ)


@dataclasses.dataclass
class AppConfig:
    """The sections of the JAX ``AppConfig`` that the port reads."""

    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    embeddings: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    ranking: RankingConfig = dataclasses.field(default_factory=RankingConfig)
    batching: BatchingConfig = dataclasses.field(default_factory=BatchingConfig)
    vector_store: VectorStoreConfig = dataclasses.field(default_factory=VectorStoreConfig)

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "AppConfig":
        return cls(
            engine=EngineConfig.from_env(environ),
            embeddings=EmbeddingConfig.from_env(environ),
            ranking=RankingConfig.from_env(environ),
            batching=BatchingConfig.from_env(environ),
            vector_store=VectorStoreConfig.from_env(environ),
        )
