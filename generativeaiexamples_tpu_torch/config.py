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

The retrieval side and the chain server read more sections of the JAX
config with its names and defaults (``LLMConfig``, ``TextSplitterConfig``,
``EmbeddingConfig``, ``RetrieverConfig``, ``RankingConfig``,
``PromptsConfig``, ``ResilienceConfig``, ``BatchingConfig``,
``VectorStoreConfig``, ``ObservabilityConfig``, ``BlackboxConfig``,
``SLOConfig``), each from ``APP_<SECTION>_<FIELD>`` as the JAX
config wizard names them (``vector_store.persist_dir`` ->
``APP_VECTORSTORE_PERSISTDIR``); ``AppConfig.from_env`` reads the engine
and all of them, and ``get_config()`` caches that once per process
(``get_config.cache_clear()`` drops it). A section's ``IGNORED`` fields
are read and checked as JAX checks them (config_validate.py), then logged
once and ignored, as the JAX runtime ignores them.

As in the JAX package, ``get_config()`` first reads the JSON or YAML file
that ``APP_CONFIG_FILE`` names, where it exists, then applies the
``APP_*`` environment on top (``AppConfig.from_file``, ``from_dict``;
config_wizard.py): a value from the file passes the same checks as the
same value from the environment.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import logging
import os
import tempfile
from typing import Mapping, Optional

from generativeaiexamples_tpu_torch import config_wizard

logger = logging.getLogger(__name__)

ENV_PREFIX = "APP_ENGINE_"

# The JAX package's EngineConfig fields (config/schema.py) that the port
# has no field for: name -> (the JAX default, why another value is refused,
# the other values the port serves as they are). A reason of None marks a
# field that exists only for XLA's compiles: logged once, ignored.
JAX_ONLY_FIELDS = {
    "serving_layout": ("auto", None, ()),
    "paged_kernel": ("auto", "the port always reads a paged pool through its kernel on the card", ()),
    "warmup_prompt_lengths": ("", None, ()),
    "chunked_prefill": ("auto", "the port always chunks prompts longer than prefill_chunk", ()),
    "quiesce_timeout_s": (600.0, None, ()),  # warmup's wait for decode to drain
}
_LOGGED: set = set()  # ignored variables already logged by this process


def _parse(name: str, raw: str, default):
    """``raw`` as the type of ``default``. A number is read as the JAX
    config wizard reads it: JSON first, then the field's type ("1.5" is 1
    for an int field, "8" is 8.0 for a float one)."""
    typ = type(default)
    try:
        if typ in (int, float):
            try:
                value = json.loads(raw)
            except ValueError:
                value = raw
            return typ(value)
        return typ(raw)
    except (TypeError, ValueError):
        raise ValueError(f"{name}={raw!r} is not a valid {typ.__name__}") from None


@dataclasses.dataclass
class EngineConfig:
    model_config_name: str = "llama3-8b"
    # a HF safetensors directory (models/hf_loader.py): its config.json
    # (else model_config_name) and its weights, streamed and quantized at
    # load; empty serves random weights (seed 0)
    checkpoint_path: str = ""
    # HF tokenizer.json; empty reads the checkpoint's, else the byte-level
    # tokenizer
    tokenizer_path: str = ""
    dtype: str = "bfloat16"
    # none | int8 (weight-only) | w8a8 (int8 weights, per-token int8 activations)
    quantization: str = "none"
    # bfloat16 | int8 | int4 paged KV pool
    kv_cache_dtype: str = "bfloat16"
    max_batch_size: int = 8
    max_seq_len: int = 8192
    # shards of the model axis (parallel/): -1, JAX's default, takes every
    # visible card, as JAX's does; N > 1 shards over N; either where the
    # heads, the MLP width and the vocab divide
    # (tp_kernels.supports_model_config)
    tensor_parallelism: int = -1
    # stages of the pipe axis (parallel/pp_serving.py): N > 1 cuts the
    # layers into N stages of tensor_parallelism shards each, over the
    # fixed KV layout; 1 (JAX's default) serves no pipeline unless the
    # fit plan picks one where num_kv_heads caps TP
    pipeline_parallelism: int = 1
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
    # auto | off: the automatic prefix KV cache (engine/prefix_cache.py):
    # a chunk-aligned prompt prefix another request prefilled is served
    # from refcounted pool pages (paged) or one store copy (fixed)
    prefix_cache_enable: str = "auto"
    # cached prefixes kept; each reserves one max_seq_len strip; 0 disables
    prefix_cache_slots: int = 4
    # drain: the budget to park the dispatch loop and checkpoint every live
    # request (past it, live requests are preempted replay-only), and a
    # restore's wait for the dispatch loop
    drain_timeout_s: float = 30.0
    # one JSON document per preempted request (engine/request_snapshot.py),
    # the oldest evicted past snapshot_spool_max
    snapshot_spool_dir: str = "/tmp/genai_snapshots"
    snapshot_spool_max: int = 64
    # unified (one dispatch thread admits, prefills and decodes) | disagg
    # (a prefill-tier thread prefills waves and hands their pages to the
    # dispatch thread's decode; paged layout only)
    scheduler_policy: str = "unified"
    # the disagg transfer queue's bound; 0 = 2 x max_batch_size
    handoff_queue_depth: int = 0
    # speculative decoding (engine/spec_decode.py): on | off; greedy rows
    # (every row under a draft model) draft up to spec_draft_len tokens a
    # dispatch, scored in one K+1-row verify dispatch; streams stay
    # token-identical to off
    spec_decode_enable: str = "off"
    # on | off: leave each verify in flight and draft the next round from
    # an optimistic context meanwhile (lookup proposer only)
    spec_pipeline_enable: str = "on"
    spec_draft_len: int = 8
    # longest tail n-gram the lookup proposer matches
    spec_ngram_max: int = 3
    # lookup | draft_model | combined
    spec_proposer: str = "lookup"
    # a models/llama.py preset for the resident draft model
    spec_draft_model: str = ""
    # a HF safetensors directory for the resident draft: its config.json
    # (else spec_draft_model) and its dense weights
    spec_draft_checkpoint_path: str = ""
    # the draft-model proposers' K; 0 inherits spec_draft_len
    spec_draft_model_len: int = 0
    # bfloat16 | int8 draft KV cache (always the fixed layout)
    spec_draft_kv_dtype: str = "bfloat16"
    # below this rolling acceptance the draft-model dispatch is skipped; 0 = never
    spec_draft_min_acceptance: float = 0.0
    # on | off: each round's K from a halving ladder driven by acceptance
    spec_adaptive_k: str = "off"
    spec_adaptive_k_min: int = 1
    spec_adaptive_k_threshold: float = 0.5

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
        tp = kwargs.get("tensor_parallelism", -1)
        if tp != -1 and tp < 1:
            name = cls.env_name("tensor_parallelism")
            raise ValueError(f"{name}={tp}: must be -1 (the default) or >= 1")
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
        if self.tensor_parallelism != -1 and self.tensor_parallelism < 1:
            raise ValueError(
                f"tensor_parallelism must be -1 (the default) or >= 1, "
                f"got {self.tensor_parallelism}"
            )
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
        from generativeaiexamples_tpu_torch.engine import kv_pages

        kv_pages.validate_config(self)  # auto falls back to fixed instead
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
        if self.prefix_cache_enable not in ("auto", "off"):
            raise ValueError(
                f"prefix_cache_enable must be auto|off, got "
                f"{self.prefix_cache_enable!r}"
            )
        if self.prefix_cache_slots < 0:
            raise ValueError(
                f"prefix_cache_slots must be >= 0, got "
                f"{self.prefix_cache_slots}"
            )
        # the scheduler and drain fields: their only checks, with the JAX
        # chain server's startup messages (config/validate.py there)
        if self.scheduler_policy not in ("unified", "disagg"):
            raise ValueError(
                f"engine.scheduler_policy must be unified|disagg, got {self.scheduler_policy!r}"
            )
        if self.handoff_queue_depth < 0:
            raise ValueError(
                f"engine.handoff_queue_depth must be >= 0 (0 auto-sizes), "
                f"got {self.handoff_queue_depth}"
            )
        if self.drain_timeout_s <= 0:
            raise ValueError(f"engine.drain_timeout_s must be > 0, got {self.drain_timeout_s}")
        if not self.snapshot_spool_dir:
            raise ValueError(
                "engine.snapshot_spool_dir must be a non-empty path (the "
                "drain workflow spools preempted requests there)"
            )
        if self.snapshot_spool_max < 1:
            raise ValueError(
                f"engine.snapshot_spool_max must be >= 1, got {self.snapshot_spool_max}"
            )
        # the spec-decode knobs: the JAX engine's checks and messages
        from generativeaiexamples_tpu_torch.engine import spec_decode

        spec_decode.validate_config(self)


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
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            kwargs[f.name] = _parse(name, raw, default)
    out = cls(**kwargs)
    for field, reason in getattr(cls, "IGNORED", {}).items():
        name = _env_name(section, field)
        if field in kwargs and name not in _LOGGED:
            _LOGGED.add(name)
            logger.info("%s=%r read and ignored: %s", name, kwargs[field], reason)
    return out


@dataclasses.dataclass
class LLMConfig:
    """The JAX config's ``llm`` section (``APP_LLM_*``)."""

    # empty means the in-process engine
    server_url: str = ""
    model_name: str = "meta-llama/Meta-Llama-3-8B-Instruct"
    # tpu|local (the in-process engine; on the card in the port),
    # openai|nvidia-ai-endpoints|remote (an OpenAI-compatible server), echo
    model_engine: str = "tpu"
    # the structured-data agent's model: read by no chain, in the JAX
    # package too; served so a deployment that sets it starts
    model_name_pandas_ai: str = "meta-llama/Meta-Llama-3-8B-Instruct"

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "LLMConfig":
        return _section_from_env(cls, "llm", environ)


@dataclasses.dataclass
class TextSplitterConfig:
    """The JAX config's ``text_splitter`` section (``APP_TEXTSPLITTER_*``):
    chunks of ``chunk_size`` whitespace words overlapping by
    ``chunk_overlap`` (the JAX runtime's splitter has no tokenizer)."""

    chunk_size: int = 510
    chunk_overlap: int = 200
    # JAX's tokenizer name: checked (not empty), then ignored, as the JAX
    # runtime's splitter ignores it
    model_name: str = "Snowflake/snowflake-arctic-embed-l"

    IGNORED = {"model_name": "the splitter counts whitespace words and reads no tokenizer"}

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "TextSplitterConfig":
        return _section_from_env(cls, "text_splitter", environ)


@dataclasses.dataclass
class RetrieverConfig:
    """The JAX config's ``retriever`` section (``APP_RETRIEVER_*``)."""

    top_k: int = 4
    score_threshold: float = 0.25
    # ranked_hybrid (dense + BM25, RRF, rerank), hybrid (no rerank), else dense
    nr_pipeline: str = "ranked_hybrid"
    # whitespace words of retrieved context given to the LLM
    context_token_cap: int = 1500
    ann_mode: str = "exact"
    ann_capacity: int = 0
    ann_max_batch: int = 8
    # off (the synchronous pipeline) | tier (batched waves on the retrieval
    # tier's worker, engine/retrieval_tier.py)
    backend: str = "off"
    # the tier's transfer queue (submitters stall past it); 0 = 16
    tier_queue_depth: int = 16
    # a wave's bounded yield to the scheduler's retrieval window; 0 = none
    tier_window_ms: int = 20

    # JAX's external retriever service: checked (a scheme), then ignored,
    # as the JAX runtime ignores it
    nr_url: str = "http://retrieval-ms:8000"

    IGNORED = {"nr_url": "no external retriever service is read"}

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "RetrieverConfig":
        return _section_from_env(cls, "retriever", environ)


@dataclasses.dataclass
class PromptsConfig:
    """The JAX config's ``prompts`` section (``APP_PROMPTS_*``), verbatim."""

    chat_template: str = (
        "You are a helpful, respectful and honest assistant."
        "Always answer as helpfully as possible, while being safe."
        "Please ensure that your responses are positive in nature."
    )
    rag_template: str = (
        "<s>[INST] <<SYS>>"
        "Use the following context to answer the user's question. If you don't know the answer,"
        "just say that you don't know, don't try to make up an answer."
        "<</SYS>>"
        "<s>[INST] Context: {context_str} Question: {query_str} Only return the helpful"
        " answer below and nothing else. Helpful answer:[/INST]"
    )
    # multi_turn's prompt: {input}, {history} (conversation memory) and
    # {context} (documents), sent as one user message
    multi_turn_rag_template: str = (
        "You are a document chatbot. Help the user as they ask questions about documents."
        " User message just asked: {input}\n\n"
        " For this, we have retrieved the following potentially-useful info: "
        " Conversation History Retrieved:\n{history}\n\n"
        " Document Retrieved:\n{context}\n\n"
        " Answer only from retrieved data. Make your response conversational."
    )

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "PromptsConfig":
        return _section_from_env(cls, "prompts", environ)


@dataclasses.dataclass
class ResilienceConfig:
    """The JAX config's ``resilience`` section (``APP_RESILIENCE_*``): the
    master switch, request deadlines, admission control, the retries and
    circuit breakers of the remote clients (utils/resilience.py) and the
    fault-injection spec the chain server installs at startup
    (utils/faults.py)."""

    enable: str = "on"
    # default per-request budget; 0 disables
    request_deadline_ms: int = 600000
    # /generate answers 429 past this many streams in flight; 0 disables
    max_active_streams: int = 64
    # /generate answers 429 while the engine's queue is this deep; 0 disables
    engine_queue_cap: int = 64
    shed_retry_after_s: float = 1.0
    # attempts per guarded dependency call; 1 disables retries
    retry_max_attempts: int = 3
    retry_base_delay_ms: int = 50
    retry_max_delay_ms: int = 2000
    retry_jitter: float = 0.5
    # consecutive failures that open a dependency's breaker, and how long
    # it stays open before one half-open probe
    breaker_failure_threshold: int = 5
    breaker_recovery_s: float = 30.0
    # site:mode[=v]@at[xN] entries joined with ';' (utils/faults.py)
    faults: str = ""

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "ResilienceConfig":
        return _section_from_env(cls, "resilience", environ)

    def validate(self) -> None:
        """The JAX package's checks of these fields, with its messages."""
        from generativeaiexamples_tpu_torch.utils.resilience import validate_config

        validate_config(self)


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
    # ranked_hybrid fetches top_k * fetch_factor candidates to rerank
    fetch_factor: int = 4

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

    # tpu|memory (the in-process store; on the card in the port),
    # faiss|native|ivf (the C++ index on the host), milvus, pgvector
    name: str = "tpu"
    # the milvus or pgvector server (http://milvus:19530, pgvector:5432);
    # unused by the in-process stores
    url: str = ""
    nlist: int = 64
    nprobe: int = 16
    persist_dir: str = "/tmp-data/vectorstore"

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "VectorStoreConfig":
        return _section_from_env(cls, "vector_store", environ)


@dataclasses.dataclass
class ObservabilityConfig:
    """The JAX config's ``observability`` section
    (``APP_OBSERVABILITY_*``): the flight recorder and its slow-request
    capture (utils/flight_recorder.py) and the dispatch timeline
    (engine/dispatch_timeline.py), each checked by its module's
    ``validate_config``."""

    flight_recorder_enable: str = "on"
    # completed timelines kept for GET /internal/requests
    flight_recorder_capacity: int = 256
    # slow-request capture triggers (ms); 0 disables each
    slow_request_ttft_ms: float = 0.0
    slow_request_total_ms: float = 0.0
    # JSONL file receiving each slow capture; "" keeps them in memory
    slow_capture_path: str = ""
    dispatch_timeline_enable: str = "on"
    # spans kept in the ring (rounded up to whole 64-span windows)
    dispatch_timeline_capacity: int = 4096

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "ObservabilityConfig":
        return _section_from_env(cls, "observability", environ)


@dataclasses.dataclass
class BlackboxConfig:
    """The JAX config's ``blackbox`` section (``APP_BLACKBOX_*``): the
    anomaly black box's switch, bundle directory, rate limit and trigger
    thresholds (utils/blackbox.py; a threshold of 0 disarms its
    trigger)."""

    enable: str = "on"
    # genai_blackbox under the temporary directory (TMPDIR), where JAX's
    # default is /tmp/genai_blackbox
    dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "genai_blackbox"))
    max_bundles: int = 8
    min_interval_s: float = 60.0
    slo_breach_streak: int = 3
    shed_spike: int = 20
    page_backpressure_storm: int = 10
    replica_death_storm: int = 3

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "BlackboxConfig":
        return _section_from_env(cls, "blackbox", environ)


@dataclasses.dataclass
class SLOConfig:
    """The JAX config's ``slo`` section (``APP_SLO_*``): the objectives
    utils/slo.py evaluates over its sliding window (a target of 0
    disables one). The two ``router_*`` objectives are the router
    process's (router/app.py calls ``slo.configure_router``)."""

    enable: str = "on"
    window_s: float = 300.0
    ttft_p95_ms: float = 30000.0
    inter_token_p95_ms: float = 1000.0
    shed_rate_max: float = 0.05
    degraded_rate_max: float = 0.05
    router_proxy_overhead_p95_ms: float = 50.0
    router_failover_rate_max: float = 0.05

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "SLOConfig":
        return _section_from_env(cls, "slo", environ)


@dataclasses.dataclass
class RouterConfig:
    """The JAX config's ``router`` section (``APP_ROUTER_*``): the routing
    tier in front of N chain-server or engine replicas (router/app.py,
    whose ``validate_config`` checks it at router startup)."""

    # comma-separated replica base URLs; ids r0, r1, ... in list order
    replicas: str = ""
    # affinity (consistent-hash ring with bounded-load spill) | round_robin
    policy: str = "affinity"
    ring_vnodes: int = 64
    # spill once a replica's inflight exceeds c * total / placeable; 0 disables
    load_bound: float = 1.25
    # spill past a replica whose last seen queue depth is at least this; 0 disables
    spill_queue_depth: int = 8
    failover_retry: str = "on"
    # sibling re-placements a request (attempts = 1 + budget)
    retry_budget: int = 1
    health_interval_s: float = 2.0
    health_fail_threshold: int = 2
    health_ok_threshold: int = 2
    health_slo_gate: str = "off"
    # name:rate=QPS,burst=N,inflight=N,weight=W,keys=k1|k2 entries joined with ';'
    tenants: str = ""
    # router-wide inflight cap for weighted fair-share shedding; 0 disables
    max_inflight: int = 0
    connect_timeout_s: float = 10.0
    # upstream socket timeout of a proxied request (seconds between reads)
    read_timeout_s: float = 600.0

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "RouterConfig":
        return _section_from_env(cls, "router", environ)


@dataclasses.dataclass
class AppConfig:
    """The sections of the JAX ``AppConfig`` that the port reads."""

    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    llm: LLMConfig = dataclasses.field(default_factory=LLMConfig)
    text_splitter: TextSplitterConfig = dataclasses.field(default_factory=TextSplitterConfig)
    embeddings: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    retriever: RetrieverConfig = dataclasses.field(default_factory=RetrieverConfig)
    ranking: RankingConfig = dataclasses.field(default_factory=RankingConfig)
    prompts: PromptsConfig = dataclasses.field(default_factory=PromptsConfig)
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)
    batching: BatchingConfig = dataclasses.field(default_factory=BatchingConfig)
    vector_store: VectorStoreConfig = dataclasses.field(default_factory=VectorStoreConfig)
    observability: ObservabilityConfig = dataclasses.field(default_factory=ObservabilityConfig)
    blackbox: BlackboxConfig = dataclasses.field(default_factory=BlackboxConfig)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "AppConfig":
        """Every section from the ``APP_*`` environment alone."""
        return cls(
            engine=EngineConfig.from_env(environ),
            llm=LLMConfig.from_env(environ),
            text_splitter=TextSplitterConfig.from_env(environ),
            embeddings=EmbeddingConfig.from_env(environ),
            retriever=RetrieverConfig.from_env(environ),
            ranking=RankingConfig.from_env(environ),
            prompts=PromptsConfig.from_env(environ),
            resilience=ResilienceConfig.from_env(environ),
            batching=BatchingConfig.from_env(environ),
            vector_store=VectorStoreConfig.from_env(environ),
            observability=ObservabilityConfig.from_env(environ),
            blackbox=BlackboxConfig.from_env(environ),
            slo=SLOConfig.from_env(environ),
            router=RouterConfig.from_env(environ),
        )

    @classmethod
    def sections(cls) -> list:
        """Each section's name and :func:`config_wizard.section_fields`
        rows: the fields the port serves, then the JAX fields it refuses
        away from their defaults."""
        out = []
        for f in dataclasses.fields(cls):
            section = f.default_factory
            if section is EngineConfig:
                unserved = {name: (default, reason)
                            for name, (default, reason, _) in JAX_ONLY_FIELDS.items()}
            else:
                unserved = {}
            out.append((f.name, config_wizard.section_fields(section, unserved)))
        return out

    @classmethod
    def from_dict(cls, data: Optional[Mapping], environ: Optional[Mapping[str, str]] = None
                  ) -> "AppConfig":
        """The configuration a (nested, camelCase) mapping sets, with the
        ``APP_*`` environment applied on top."""
        env = os.environ if environ is None else environ
        return cls.from_env({**config_wizard.file_environ(cls.sections(), data or {}), **env})

    @classmethod
    def from_file(cls, filepath: str, environ: Optional[Mapping[str, str]] = None
                  ) -> Optional["AppConfig"]:
        """The configuration a JSON or YAML file sets, the environment on
        top; None when the file cannot be read or holds no mapping."""
        try:
            with open(filepath, "r", encoding="utf-8") as fh:
                data = config_wizard.read_json_or_yaml(fh.read())
        except OSError:
            return None
        if data is None:
            return None
        return cls.from_dict(data, environ)

    @classmethod
    def print_help(cls, help_printer) -> None:
        """The schema with its ``APP_*`` names, types and defaults."""
        config_wizard.print_help(cls.sections(), help_printer)


def load_config(environ: Optional[Mapping[str, str]] = None) -> AppConfig:
    """The file ``APP_CONFIG_FILE`` names, where it exists, with the
    environment on top; the environment alone otherwise."""
    env = os.environ if environ is None else environ
    config_file = env.get("APP_CONFIG_FILE", "")
    config = None
    if config_file and os.path.exists(config_file):
        config = AppConfig.from_file(config_file, environ)
    if config is None:
        config = AppConfig.from_env(environ)
    return config


@functools.lru_cache(maxsize=1)
def get_config() -> AppConfig:
    """The process configuration, :func:`load_config` read once;
    ``get_config.cache_clear()`` makes the next call read it again."""
    return load_config()
