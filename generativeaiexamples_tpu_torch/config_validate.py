"""Startup validation of the config sections the chain server reads.

The port's copy of the JAX package's
generativeaiexamples_tpu/config/validate.py, limited to the fields of the
port's ``AppConfig`` (config.py), with the JAX package's messages verbatim:
a bad value stops the chain server at startup (``server/api.py``
``make_server``) instead of failing at the first request, or answering
quietly wrong (``retriever.top_k`` 0 answers the no-context message).

A JAX engine field the port has no field for (``JAX_ONLY_FIELDS``,
config.py) needs no check here: ``from_env`` has refused any value the
port does not serve already. A section's ``IGNORED`` fields are checked as
JAX checks them, and then go unread, as in the JAX runtime.
The engine fields that ``EngineConfig.validate`` checks for the port's own
engine (the serving layout, the page geometry, the scheduler and drain
fields) are not repeated; the spec-decode fields are checked by
``engine/spec_decode.validate_config``, which gives the startup check's
messages when called from here. The ``observability``, ``blackbox`` and
``slo`` sections are checked by their modules' ``validate_config``
(:func:`validate_observability`), as the JAX servers check them.
"""
from __future__ import annotations

_LLM_ENGINES = ("tpu", "local", "openai", "nvidia-ai-endpoints", "remote", "echo")
_EMBED_ENGINES = ("", "tpu", "openai", "nvidia-ai-endpoints", "remote", "hash")
_RANKING_ENGINES = ("", "tpu", "remote", "overlap")
_RETRIEVER_PIPELINES = ("ranked_hybrid", "hybrid")
_RETRIEVER_BACKENDS = ("off", "tier")
_ANN_MODES = ("exact", "ivf")
_ENGINE_DTYPES = ("bfloat16", "float32", "float16")
_QUANTIZATIONS = ("none", "int8", "w8a8")
_KV_DTYPES = ("bfloat16", "int8", "int4")
_REMOTE = ("openai", "nvidia-ai-endpoints", "remote")


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def validate_config(cfg) -> None:
    """Raise ValueError, naming the knob, on the first value the JAX chain
    server's startup refuses."""
    vs = cfg.vector_store
    _require(bool(vs.name.strip()), "vector_store.name must not be empty")
    _require(vs.nlist > 0, f"vector_store.nlist must be > 0, got {vs.nlist}")
    _require(vs.nprobe > 0, f"vector_store.nprobe must be > 0, got {vs.nprobe}")
    _require(bool(vs.persist_dir.strip()), "vector_store.persist_dir must not be empty")

    llm = cfg.llm
    engine_kind = (llm.model_engine or "tpu").lower()
    _require(engine_kind in _LLM_ENGINES,
             f"llm.model_engine must be one of {_LLM_ENGINES}, got {llm.model_engine!r}")
    _require(bool(llm.model_name.strip()), "llm.model_name must not be empty")
    _require(bool(llm.model_name_pandas_ai.strip()),
             "llm.model_name_pandas_ai must not be empty")
    if engine_kind in _REMOTE:
        _require(bool(llm.server_url),
                 f"llm.model_engine={engine_kind!r} requires llm.server_url (APP_LLM_SERVERURL)")

    ts = cfg.text_splitter
    _require(bool(ts.model_name.strip()), "text_splitter.model_name must not be empty")
    _require(ts.chunk_size > 0, f"text_splitter.chunk_size must be > 0, got {ts.chunk_size}")
    _require(0 <= ts.chunk_overlap < ts.chunk_size,
             f"text_splitter.chunk_overlap must be in [0, chunk_size), "
             f"got {ts.chunk_overlap} (chunk_size {ts.chunk_size})")

    emb = cfg.embeddings
    _require((emb.model_engine or "").lower() in _EMBED_ENGINES,
             f"embeddings.model_engine must be one of {_EMBED_ENGINES}, "
             f"got {emb.model_engine!r}")
    _require(bool(emb.model_name.strip()), "embeddings.model_name must not be empty")
    _require(emb.dimensions > 0, f"embeddings.dimensions must be > 0, got {emb.dimensions}")
    _require(emb.query_cache_size >= 0,
             f"embeddings.query_cache_size must be >= 0 (0 disables), "
             f"got {emb.query_cache_size}")
    if (emb.model_engine or "").lower() in _REMOTE:
        _require(bool(emb.server_url),
                 f"embeddings.model_engine={emb.model_engine!r} requires "
                 f"embeddings.server_url (APP_EMBEDDINGS_SERVERURL)")

    ret = cfg.retriever
    _require(ret.top_k > 0, f"retriever.top_k must be > 0, got {ret.top_k}")
    _require(0.0 <= ret.score_threshold <= 1.0,
             f"retriever.score_threshold must be in [0, 1], got {ret.score_threshold}")
    _require(ret.nr_pipeline in _RETRIEVER_PIPELINES,
             f"retriever.nr_pipeline must be one of {_RETRIEVER_PIPELINES}, "
             f"got {ret.nr_pipeline!r}")
    _require(ret.context_token_cap >= 0,
             f"retriever.context_token_cap must be >= 0 (0 disables), "
             f"got {ret.context_token_cap}")
    if ret.nr_url:
        _require("://" in ret.nr_url,
                 f"retriever.nr_url must carry a scheme (http://host:port), got {ret.nr_url!r}")
    _require((ret.ann_mode or "exact").lower() in _ANN_MODES,
             f"retriever.ann_mode must be one of {_ANN_MODES}, got {ret.ann_mode!r}")
    _require(ret.ann_capacity >= 0,
             f"retriever.ann_capacity must be >= 0 (0 auto-sizes), got {ret.ann_capacity}")
    _require(ret.ann_max_batch >= 1,
             f"retriever.ann_max_batch must be >= 1, got {ret.ann_max_batch}")
    _require((ret.backend or "off").lower() in _RETRIEVER_BACKENDS,
             f"retriever.backend must be one of {_RETRIEVER_BACKENDS}, got {ret.backend!r}")
    _require(ret.tier_queue_depth >= 0,
             f"retriever.tier_queue_depth must be >= 0 (0 auto-sizes), "
             f"got {ret.tier_queue_depth}")
    _require(ret.tier_window_ms >= 0,
             f"retriever.tier_window_ms must be >= 0 (0 disables the "
             f"co-scheduling yield), got {ret.tier_window_ms}")
    if (ret.backend or "off").lower() == "tier":
        _require((cfg.vector_store.name or "tpu").lower() in ("tpu", "memory"),
                 f"retriever.backend=tier requires the in-process TPU "
                 f"vector store (vector_store.name=tpu), got "
                 f"vector_store.name={cfg.vector_store.name!r}")

    rk = cfg.ranking
    _require((rk.model_engine or "").lower() in _RANKING_ENGINES,
             f"ranking.model_engine must be one of {_RANKING_ENGINES} "
             f"('' disables), got {rk.model_engine!r}")
    _require(bool(rk.model_name.strip()), "ranking.model_name must not be empty")
    _require(rk.fetch_factor >= 1, f"ranking.fetch_factor must be >= 1, got {rk.fetch_factor}")
    if (rk.model_engine or "").lower() == "remote":
        _require(bool(rk.server_url),
                 "ranking.model_engine=remote requires ranking.server_url "
                 "(APP_RANKING_SERVERURL)")

    pr = cfg.prompts
    _require(bool(pr.chat_template.strip()), "prompts.chat_template must not be empty")
    _require(bool(pr.rag_template.strip()), "prompts.rag_template must not be empty")
    _require(bool(pr.multi_turn_rag_template.strip()),
             "prompts.multi_turn_rag_template must not be empty")

    e = cfg.engine
    _require(e.tensor_parallelism == -1 or e.tensor_parallelism > 0,
             f"engine.tensor_parallelism must be -1 (all devices) or > 0, "
             f"got {e.tensor_parallelism}")
    _require(e.pipeline_parallelism >= 1,
             f"engine.pipeline_parallelism must be >= 1, "
             f"got {e.pipeline_parallelism}")
    _require(e.dtype in _ENGINE_DTYPES,
             f"engine.dtype must be one of {_ENGINE_DTYPES}, got {e.dtype!r}")
    _require(e.quantization in _QUANTIZATIONS,
             f"engine.quantization must be one of {_QUANTIZATIONS}, got {e.quantization!r}")
    _require(e.kv_cache_dtype in _KV_DTYPES,
             f"engine.kv_cache_dtype must be one of {_KV_DTYPES}, got {e.kv_cache_dtype!r}")
    _require(e.max_batch_size > 0, f"engine.max_batch_size must be > 0, got {e.max_batch_size}")
    _require(e.max_seq_len > 0, f"engine.max_seq_len must be > 0, got {e.max_seq_len}")
    _require(bool(e.model_config_name.strip()), "engine.model_config_name must not be empty")
    _require(e.prefill_wave_tokens > 0,
             f"engine.prefill_wave_tokens must be > 0, got {e.prefill_wave_tokens}")
    _require(e.decode_runahead >= 1,
             f"engine.decode_runahead must be >= 1, got {e.decode_runahead}")
    _require(e.decode_block >= 1, f"engine.decode_block must be >= 1, got {e.decode_block}")
    _require(e.stream_timeout_s > 0,
             f"engine.stream_timeout_s must be > 0, got {e.stream_timeout_s}")
    _require(
        e.max_queued_requests == 0 or e.max_queued_requests >= e.max_batch_size,
        f"engine.max_queued_requests must be 0 (unbounded) or >= "
        f"max_batch_size so warmup's full admission waves fit, got "
        f"{e.max_queued_requests} (max_batch_size {e.max_batch_size})",
    )
    _require(e.watchdog_stall_s >= 0,
             f"engine.watchdog_stall_s must be >= 0 (0 disables), got {e.watchdog_stall_s}")
    _require(e.prefix_cache_enable in ("auto", "off"),
             f"engine.prefix_cache_enable must be auto|off, "
             f"got {e.prefix_cache_enable!r}")
    _require(e.prefix_cache_slots >= 0,
             f"engine.prefix_cache_slots must be >= 0 (0 disables), "
             f"got {e.prefix_cache_slots}")
    # the spec-decode fields: the engine's one set of rules, refused with
    # this check's text where it has one
    from generativeaiexamples_tpu_torch.engine import spec_decode

    spec_decode.validate_config(e, startup=True)

    # the observability sections: each module's own checks, with JAX's
    # messages (the JAX chain server runs these four at startup)
    validate_observability(cfg)


def validate_observability(cfg) -> None:
    """The ``observability``, ``blackbox`` and ``slo`` sections' checks
    (both servers run them at startup)."""
    from generativeaiexamples_tpu_torch.engine import dispatch_timeline
    from generativeaiexamples_tpu_torch.utils import blackbox, flight_recorder, slo

    flight_recorder.validate_config(cfg)
    dispatch_timeline.validate_config(cfg)
    slo.validate_config(cfg)
    blackbox.validate_config(cfg)


def configure_observability(cfg) -> None:
    """Wire the three sections into the flight recorder, the SLO tracker,
    the black box and the dispatch timeline (both servers, at startup)."""
    from generativeaiexamples_tpu_torch.engine import dispatch_timeline
    from generativeaiexamples_tpu_torch.utils import blackbox, flight_recorder, slo

    flight_recorder.configure_from_config(cfg)
    slo.configure_from_config(cfg)
    blackbox.configure_from_config(cfg)
    dispatch_timeline.configure_from_config(cfg)
