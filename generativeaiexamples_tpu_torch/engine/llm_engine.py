"""In-process LLM serving engine: continuous batching over a paged KV pool
or fixed per-slot KV strips.

Counterpart of generativeaiexamples_tpu/engine/llm_engine.py on its main
serving path (unified scheduler, layered programs, both KV layouts), with
the same public surface: ``SamplingParams``, ``submit``, ``generate_ids``,
``iter_ids``, ``stream_text``, ``chat``, ``abort``, ``shutdown`` and
``get_engine``.

``kv_layout`` resolves as in JAX: ``auto`` pages wherever the page
geometry tiles and otherwise logs its blockers and serves ``fixed``; the
streams are token-identical between the layouts.

Three named daemon threads share the work, as in JAX:

- the dispatch thread (``_loop``) does all device work and never waits on
  the device. Slot state lives in device tensors (``_tokens_dev``,
  ``_positions_dev``, ``_temps_dev``, ``_topps_dev``, ``_seeds_dev``,
  ``_live_dev``) that admission patches by one indexed write each
  (``_update_slots``) and each decode block reads and writes, its last
  tokens feeding the next block. Every copy from the host goes through
  pinned memory without waiting (``_to_device``). Each pass it

  1. frees the slots the reader found finished (``_release_q``);
  2. admits a wave of pending requests (up to the free slots and
     ``prefill_wave_tokens``); on the paged layout it funds each with
     every page it can touch (``_fund``), a fixed slot always holds
     ``max_seq_len`` rows;
  3. prefills prompts of up to ``prefill_chunk`` tokens monolithically
     (``llama.prefill_layers`` + ``write_prefill_pages`` or
     ``write_prefill_slots``; the flash kernel serves the wave from
     T = 512), and longer prompts chunk by chunk
     (``llama.extend_layers_paged`` or ``llama.extend_layers``);
  4. frees budget-exhausted and cancelled slots from host shadows of each
     slot's budget and position (``_slot_budget``, ``_slot_pos``), then
     decodes all slots in a block of ``decode_block`` steps
     (``llama.decode_layers_paged`` with the paged-attention kernel, or
     ``llama.decode_layers`` with the decode-attention kernel over an
     int8 fixed cache; the int8 or W8A8 matmul kernel serves every
     projection), greedy or sampled with the JAX package's threefry keys;

  and hands each wave's first tokens and each block's token slab to the
  reader as a non-blocking copy into pinned memory with a CUDA event,
  through a queue of ``decode_runahead`` items: a full queue is its only
  backpressure;
- the reader thread (``_reader_loop``) waits on each item's event (the
  one sync per block), emits the tokens to each request's queue with
  stop ids and ``max_tokens``, and sends finished slots back through
  ``_release_q``; it keeps the decode metrics;
- the watchdog thread (``_watchdog_loop``, when ``watchdog_stall_s`` > 0)
  marks the engine wedged (``engine_wedged()``) while the dispatch loop
  makes no progress with work outstanding.

``submit`` raises ``EngineOverloaded`` once ``max_queued_requests``
requests wait for a slot. ``hold_admissions`` pauses admission while
requests enqueue; ``is_decoding`` and ``scheduler.ingest_window`` (the
``unified`` policy's decode-idle wait, woken when the dispatch thread
frees the last slot) are what the retrieval embedder asks before bulk
work.

The automatic prefix KV cache (``prefix_cache_enable='auto'``, the JAX
default; engine/prefix_cache.py) indexes each chunked prompt's
chunk-aligned prefix after its prefill. A later request whose prompt
starts with a cached prefix (matched at admission, before funding)
prefills only the chunks past it: on the paged layout its page table
maps the entry's refcounted pages (no device work; ``_fund``), on the
fixed layout one copy brings the rows from the prefix store into its
strip before the first chunk (``llama.copy_kv_rows``). Either way the
copies and maps are ordered on the dispatch thread's stream and nothing
waits for the device.

Dead slots decode at position 0: on the paged layout they write the
scratch page, on the fixed layout rows of their own strip, as in JAX.

Admission goes through the scheduler seam (engine/scheduler/):
``unified`` (the default) claims, registers and prefills a wave on the
dispatch thread as above; ``disagg`` (paged layout only) runs the claim
and the prefill on a prefill-tier thread and the dispatch thread imports
each finished request between decode blocks (``_import_handoff``).

Preemption (JAX's drain lifecycle): ``drain`` parks the dispatch loop at
a block boundary, lets the reader emit every block already dispatched
(a barrier through the readback queue), captures each live request with
its KV pages (engine/request_snapshot.py) into the spool, fails its
stream with ``RequestPreempted`` carrying the snapshot id, and releases
its slot and pages; a request with no KV to carry (unadmitted, the fixed
layout, a missed park) is preempted replay-only. ``restore_snapshot``
re-admits a document on any engine of the same config: the dispatch
thread claims a slot and pages, scatters the payload into the pool
(``request_snapshot.write_pages``: split over the shards), writes the slot state and registers the request, which
then decodes on from the spooled position (``stream_restored``
re-delivers the spooled tokens first). The ``engine.dispatch`` and
``replica.kill`` fault points (utils/faults.py) sit at the top of each
dispatch pass.

Speculative decoding (engine/spec_decode.py, engine/spec_draft.py): with
``spec_decode_enable`` on, while any live row can draft, each dispatch is
one verify (``spec_verify_paged`` through the page kernel's K+1 query
rows, or ``spec_verify`` on the fixed layout) instead of a block: the
proposer (prompt lookup over each row's own context, or the resident
draft model) drafts up to K tokens a row, the verify samples every
position with plain decode's keys and accepts the leading draft tokens
the target itself would emit, so streams are token-identical to spec
off. The packed ``[B, K+2]`` result is the dispatch thread's one read
back a round (``spec_decode.allowed_sync``); pipelined
(``spec_pipeline_enable`` on), it lands one dispatch later while the
next round is drafted from the optimistic context. A round with no
draft runs the plain block and reads its slab back.

Observability (counterparts of JAX's): the engine registers JAX's
``genai_engine_*`` families under the same names and stamps the same
flight-recorder events (utils/flight_recorder.py: ``submit``, ``admit``,
``prefix_match``, ``page_alloc``, ``prefill_wave``/``prefill_chunk``,
``decode_join``, ``first_token``, ``spec_verify``, ``decode_leave``,
``page_free``, ``abort``, ``preempt``, ``restore`` ...). Every dispatch
(prefill wave, chunk, decode block, verify, zero-draft block) records one
host entry in the utilization estimator (engine/telemetry.py) and one span
in the dispatch timeline (engine/dispatch_timeline.py), and runs under a
``torch.profiler.record_function`` label when ENABLE_PROFILING is set
(utils/profiling.py). The timeline and the profiling labels are resolved
once at init (``GENAI_DISPATCH_TIMELINE=off`` leaves the dispatch path
as it was). None of it reads the device: on the card a span's run time is
the launch time, and device time comes only from a profile.

Tensor parallelism (parallel/, the JAX engine's TP kernel path): with
``mesh=`` (parallel/mesh.py), or ``device=None`` and ``tensor_parallelism``
N > 1 (``-1``, the default, takes every visible card, as JAX's does), the
engine lays its single-device tree out per shard and cuts it, keeps each
KV pool or strip as one pool a shard of ``Hkv / N`` heads, and threads its
``TPContext`` through every model call: each shard runs the kernels on
its local tile, the row-parallel partials are summed in f32 in shard
order, and the replicated activations, the page tables, the slot state
and the sampler stay on the first shard's device. The kernel gates ask
about the local tile. Every path serves across shards: the spec verify
(K+1 rows a slot through the local tiles), the resident draft on the
engine's mesh (engine/spec_draft.py), drain's snapshots (each shard's
heads gathered into the full model's payload, split back at restore:
engine/request_snapshot.py), ``disagg`` (JAX's advisory tier plan,
parallel/mesh.py ``tier_submeshes``) and the retrieval tier beside the
engine.

Pipeline parallelism (parallel/pp_serving.py, the JAX engine's PP branch):
``pipeline_parallelism`` > 1, a mesh with a ``pipe`` axis, or JAX's
automatic choice where ``num_kv_heads`` caps TP below the device count
and the capped mesh cannot hold the model (``_resolve_parallelism``)
builds ``_pp``: the layers cut into stages of TP shards each, a fixed KV
cache a layer on its stage's devices, and a prefill and a block decode
that walk the stages in order, with the scheduler's signatures. As in
JAX, the PP path serves the fixed layout only (``kv_layout`` paged and
``kv_cache_dtype`` int4 are refused, ``auto`` serves fixed), prefills
every prompt in one wave, and builds neither the prefix cache nor
speculative decoding; ``disagg`` refuses it; drain preempts its requests
replay-only, as on any fixed layout.

Weights (JAX's rule): ``checkpoint_path`` names a HF safetensors
directory, whose ``config.json`` (else ``model_config_name``) is the
model and whose tensors stream into the serving layout
(``hf_loader.load_params_layered_streaming``: each layer transposed,
quantized to int8 packs on the device and cut into its shards as its
tensors complete; ``load_stats`` keeps the load's ``peak_host_bytes`` and
seconds); the tokenizer is ``tokenizer_path`` or the checkpoint's
``tokenizer.json``, else the byte tokenizer. A path without
``.safetensors`` raises at build, never falling back to random weights.
``params=`` passes a tree in memory; with neither, the weights are random
(seed 0).

The engine runs on the card: ``device=None`` means CUDA and raises when
no card is present. Tests pass ``device="cpu"`` (or a mesh of ``cpu``
shards), where every kernel wrapper runs its plain PyTorch version.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import queue
import random
import threading
import time
import weakref
from typing import Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import dispatch_timeline as dispatch_timeline_mod
from generativeaiexamples_tpu_torch.engine import kv_pages, prefix_cache
from generativeaiexamples_tpu_torch.engine import telemetry as telemetry_mod
from generativeaiexamples_tpu_torch.engine import request_snapshot as request_snapshot_mod
from generativeaiexamples_tpu_torch.utils import provenance as provenance_mod
from generativeaiexamples_tpu_torch.engine import spec_decode as spec_decode_mod
from generativeaiexamples_tpu_torch.engine.scheduler import handoff as handoff_mod
from generativeaiexamples_tpu_torch.engine.scheduler.base import build_policy
from generativeaiexamples_tpu_torch.engine.tokenizer import load_tokenizer
from generativeaiexamples_tpu_torch.models import hf_loader, llama, sampling
from generativeaiexamples_tpu_torch.ops import (
    decode_attention, flash_attention, int8_matmul, page_attention, quant,
)
from generativeaiexamples_tpu_torch.parallel import mesh as mesh_mod
from generativeaiexamples_tpu_torch.parallel import pp_serving, sharding, tp_kernels
from generativeaiexamples_tpu_torch.utils import faults as faults_mod
from generativeaiexamples_tpu_torch.utils import flight_recorder
from generativeaiexamples_tpu_torch.utils import hardware
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod
from generativeaiexamples_tpu_torch.utils import profiling
from generativeaiexamples_tpu_torch.utils import slo as slo_mod
from generativeaiexamples_tpu_torch.utils.resilience import EngineOverloaded, RequestPreempted

logger = logging.getLogger(__name__)

# Engine metric families: JAX's, registered at import (a scrape sees the
# whole catalog before any engine is built). The scheduling-phase
# histograms carry the request's trace id (captured at submit) as their
# exemplar.
_REG = metrics_mod.get_registry()
_M_REQUESTS = _REG.counter(
    "genai_engine_requests_total", "Requests submitted to the LLM engine."
)
_M_TOKENS = _REG.counter(
    "genai_engine_generated_tokens_total", "Tokens emitted by the decode loop."
)
_M_DECODE_STEPS = _REG.counter(
    "genai_engine_decode_steps_total",
    "Decode steps executed (decode_block steps per dispatch).",
)
_M_WAVES = _REG.counter(
    "genai_engine_admission_waves_total", "Prefill admission waves dispatched."
)
_M_DECODE_DISPATCHES = _REG.counter(
    "genai_engine_decode_dispatches_total",
    "Decode/verify dispatches issued (one compiled-program launch each; "
    "a decode dispatch runs decode_block steps, a spec verify dispatch "
    "runs one multi-token step).",
)
_M_PREFILL_CHUNKS = _REG.counter(
    "genai_engine_prefill_chunks_total",
    "Fixed-shape chunk dispatches run by chunked prefill.",
)
_M_QUEUE_WAIT = _REG.histogram(
    "genai_engine_queue_wait_seconds",
    "Submit -> slot-claimed wait (admission queueing).",
    # Bucket audit (PR 16): queue waits are a seconds-scale phase (a
    # full batch holds admissions for whole decode generations) — the
    # default preset burned its bottom half on sub-ms buckets this
    # family never fills while its 120 s ceiling saturated under
    # sustained overload. ~100x slower scale than the inter-token
    # family below, so it gets the slow preset.
    buckets=metrics_mod.SLOW_SECONDS_BUCKETS,
)
_M_TTFT = _REG.histogram(
    "genai_engine_ttft_seconds", "Submit -> first generated token."
)
_M_PREFILL_WAIT = _REG.histogram(
    "genai_engine_prefill_wait_seconds",
    "Slot-claimed -> first token (prefill + first readback).",
)
_M_TOKEN_LATENCY = _REG.histogram(
    "genai_engine_token_latency_seconds",
    "Inter-token emission interval per request (slab cadence included).",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
             0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0),
)
_M_READBACK = _REG.histogram(
    "genai_engine_readback_wait_seconds",
    "Reader-thread stall for a dispatch's device results, by kind.",
    ("kind",),
)
_M_SLOTS_IN_USE = _REG.gauge(
    "genai_engine_batch_slots_in_use",
    "Decode slots currently occupied by live requests.",
)
_M_SLOTS_CAPACITY = _REG.gauge(
    "genai_engine_batch_slots_capacity",
    "Configured decode slot count (max_batch_size).",
)
_M_KV_UTILIZATION = _REG.gauge(
    "genai_engine_kv_cache_utilization_ratio",
    "Fraction of KV-cache rows holding live sequence state.",
)
_M_ABORTS = _REG.counter(
    "genai_engine_aborts_total",
    "Requests aborted before completion (client disconnects, explicit "
    "abort() calls, stream-stop early exits) — their slots and prefix "
    "pins were released early.",
)
_M_OVERLOAD = _REG.counter(
    "genai_engine_overload_rejections_total",
    "submit() calls rejected with EngineOverloaded by the admission "
    "queue-depth cap (max_queued_requests).",
)
_M_QUEUE_DEPTH = _REG.gauge(
    "genai_engine_queue_depth",
    "Requests waiting in the admission queue (submitted, no slot yet).",
)
_M_WEDGED = _REG.gauge(
    "genai_engine_wedged",
    "1 while the dispatch-loop watchdog sees work outstanding with no "
    "dispatch progress past watchdog_stall_s (readiness flips unready).",
)
_M_SPEC_PIPE_ROLLBACKS = _REG.counter(
    "genai_engine_spec_pipeline_rollbacks_total",
    "Speculative runahead drafts invalidated by the verify readback "
    "(slot-rounds whose optimistic full-acceptance assumption missed; "
    "the row re-proposed from the true buffers — a host-work cost, "
    "never a correctness event).",
)
_M_SPEC_PIPE_CONFIRMED = _REG.counter(
    "genai_engine_spec_pipeline_confirmed_total",
    "Speculative runahead drafts confirmed by the verify readback "
    "(slot-rounds dispatched with zero proposal work on the critical "
    "path — the draft was proposed while the previous verify ran).",
)
_M_PAGED_ATTN = _REG.counter(
    "genai_engine_paged_attn_dispatches_total",
    "Paged-layout attention dispatches by serving path: path='kernel' "
    "(the ragged Pallas page-attention kernel, ops/page_attention.py — "
    "per-row DMA grids clamped to live pages) vs path='gather' (the "
    "XLA dequant-gather fallback reading the bucketed window). A paged "
    "engine whose geometry the kernel refuses logs the fallback loudly "
    "at startup and shows every decode dispatch under 'gather' here.",
    ("path",),
)
_M_PREFIX_COPY = _REG.counter(
    "genai_engine_prefix_copy_dispatches_total",
    "Compiled gather/update copy programs dispatched by the FIXED KV "
    "layout's prefix cache (store->slot fetch at admission, slot->store "
    "insert post-prefill). The paged layout maps refcounted pages "
    "instead — its hits keep this counter flat (the zero-copy "
    "assertion bench and tests pin).",
)


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.2
    top_p: float = 0.7
    max_tokens: int = 1024
    stop: Tuple[str, ...] = ()
    seed: int = 0
    # the chain or session a request belongs to: bumps its cached
    # prefix's recency at submit (advisory; matching is by content)
    prefix_hint: Optional[str] = None
    # speculative decoding for this request: None follows the engine's
    # spec_decode_enable, False opts out (the row still rides each verify
    # dispatch as a single-token row), True is advisory
    spec_decode: Optional[bool] = None


@dataclasses.dataclass(eq=False)
class _Request:
    rid: int
    prompt_ids: List[int]
    params: SamplingParams
    out_queue: "queue.Queue[Optional[int]]" = dataclasses.field(
        default_factory=lambda: queue.Queue()
    )
    slot: int = -1
    # params.seed when given, else a fresh draw: unseeded requests must
    # not share a noise stream
    sampling_seed: int = 0
    t_submit: float = 0.0
    position: int = 0  # position of the next decode input token
    generated: int = 0
    # every generated token in order, stop tokens included (the reader
    # appends): the transcript a drain spools; emitted[-1] is the token
    # whose KV row is not written yet
    emitted: List[int] = dataclasses.field(default_factory=list)
    cancelled: bool = False
    finished: bool = False
    error: Optional[BaseException] = None
    # the matched prefix-cache entry, pinned until its rows are secured
    # (the fixed fetch or the paged retain), and the rows it serves
    prefix_entry: Optional[prefix_cache.PrefixEntry] = None
    prefix_len: int = 0
    # observability: slot-claim time (0 until the first claim), the last
    # token's emission time, the submitting thread's trace id, and the
    # flight record the rid maps to
    t_admit: float = 0.0
    t_last_token: float = 0.0
    trace_hex: Optional[str] = None
    flight_rec: Optional[object] = None


_END = None  # sentinel on out_queue
_REQ_IDS = itertools.count(1)
_UNSEEDED_RNG = random.SystemRandom()


# Set while the dispatch-loop watchdog (or a shutdown that timed out)
# finds the engine wedged; the server's readiness routes read it.
ENGINE_WEDGED = threading.Event()


def engine_wedged() -> bool:
    """Whether the watchdog currently considers the engine wedged."""
    return ENGINE_WEDGED.is_set()


def resolve_device(device=None, what: str = "LLMEngine") -> torch.device:
    """``None`` means the card. A CUDA device with no card present is an
    error, never a quiet fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU (tests)"
        )
    return dev


def device_memory_bytes(device: torch.device) -> float:
    """A device's memory: the card's total, or the JAX package's 16 GB
    default for a device that reports none (the CPU)."""
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return 16e9


def _prefix_store_extra_slots(cfg: EngineConfig) -> int:
    """Prefix-cache slots the config asks for: each reserves one
    ``max_seq_len`` strip (pool pages on the paged layout, a store slot
    on the fixed one). The port always chunks and is always layered, the
    two other conditions of the JAX rule."""
    if cfg.prefix_cache_enable != "off":
        return cfg.prefix_cache_slots
    return 0


def _cache_tensors(caches):
    """Every tensor of per-layer caches, each shard's of a sharded layer."""
    for c in caches:
        for piece in (c if isinstance(c, sharding.Shards) else [c]):
            yield from piece.values()


def _next_stream_item(out_q, stall_s, deadline):
    """One bounded wait for the next streamed item: ``stall_s`` bounds the
    wait for this item only; ``deadline`` is an absolute whole-stream
    budget. Exactly one of the two is not None."""
    wait = stall_s if deadline is None else deadline - time.time()
    if wait is not None and wait <= 0:
        raise TimeoutError("LLM engine timed out")
    try:
        return out_q.get(timeout=wait)
    except queue.Empty:
        raise TimeoutError("LLM engine timed out") from None


class LLMEngine:
    def __init__(
        self,
        config: Optional[EngineConfig] = None,
        device=None,
        params=None,
        draft_params=None,
        mesh: Optional[mesh_mod.Mesh] = None,
    ):
        cfg = config or EngineConfig()
        cfg.validate()
        self.engine_config = cfg
        # the model: the checkpoint's config.json, else the preset (JAX's rule)
        model_cfg = hf_loader.config_from_hf(cfg.checkpoint_path) if cfg.checkpoint_path else None
        if model_cfg is None:
            if cfg.model_config_name not in llama.PRESETS:
                raise ValueError(f"unknown model_config_name {cfg.model_config_name!r}")
            model_cfg = llama.PRESETS[cfg.model_config_name]
        self.model_config = model_cfg
        self._init_mesh(cfg, model_cfg, device, mesh)
        self.tokenizer = load_tokenizer(cfg.tokenizer_path or cfg.checkpoint_path)
        # Sample only ids the tokenizer can represent (the byte tokenizer
        # under a 128k-vocab head would otherwise stream blanks).
        tok_vocab = getattr(self.tokenizer, "vocab_size", 0) or model_cfg.vocab_size
        self._sample_vocab = min(model_cfg.vocab_size, max(tok_vocab, 1))
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
        self.num_slots = cfg.max_batch_size
        self.max_seq_len = min(cfg.max_seq_len, model_cfg.max_seq_len)
        self._page = cfg.page_size
        self._decode_block = cfg.decode_block
        if self._pp is not None:
            if cfg.kv_layout == "paged":
                raise ValueError(
                    "kv_layout='paged' is not supported on the pipeline-"
                    "parallel serving path; use kv_layout='fixed' (the "
                    "PP stage caches keep the dense per-slot layout)"
                )
            if cfg.kv_cache_dtype == "int4":
                raise ValueError(
                    "kv_cache_dtype='int4' requires the paged KV layout, "
                    "which the pipeline-parallel serving path does not "
                    "support; use kv_cache_dtype='int8'"
                )
            self._paged = False  # 'auto' serves the stages' fixed layout, as in JAX
        elif cfg.kv_layout == "auto":
            blockers = kv_pages.auto_layout_blockers(cfg, self.max_seq_len)
            self._paged = not blockers
            if blockers:
                logger.info("kv_layout='auto' resolved to 'fixed': %s", "; ".join(blockers))
        else:
            self._paged = cfg.kv_layout == "paged"
        if self._paged:
            self._pool_pages = kv_pages.pool_pages(
                cfg, self.max_seq_len, _prefix_store_extra_slots(cfg)
            )
            kv_pages.validate_runtime(self._page, self.max_seq_len, self._pool_pages)
            self._max_pages_per_slot = kv_pages.pages_for_tokens(self.max_seq_len, self._page)
            # a decode block can write up to a block past a request's budget,
            # whatever the runahead (_decode_once), and a verify chunk K + 1
            # rows: the effective draft width, the one rule the verify, the
            # draft caps and the draft model share (JAX's funding slack)
            self._page_slack = (
                cfg.decode_block + spec_decode_mod.effective_draft_len(cfg) + 1
            )

        self._kv_quant = cfg.kv_cache_dtype in ("int8", "int4")
        self._kv_packed = cfg.kv_cache_dtype == "int4"
        if self._kv_packed and not self._paged:
            # the fixed head-major int8 cache has no packed variant
            raise ValueError(
                "kv_cache_dtype='int4' requires the paged KV layout on the layered "
                "serving path; this config resolved kv_layout='fixed' (set "
                "kv_layout='paged' with a page geometry that tiles, or use "
                "kv_cache_dtype='int8')"
            )
        if self._kv_packed and model_cfg.head_dim % 2:
            raise ValueError(
                "kv_cache_dtype='int4' packs two values per byte along "
                f"head_dim, which must be even (got {model_cfg.head_dim})"
            )
        # the packed product's mode (int8_matmul.packed_matmul): w8a8 runs
        # per-token int8 activations over the same int8 packs
        self._quant_kernel = "w8a8" if cfg.quantization == "w8a8" else None
        # the attention kernel of each layout: the page kernel reads the
        # pool, the decode kernel an int8 fixed cache (a bf16 fixed cache
        # is read by the einsum attention, as in JAX); under TP each gate
        # asks the LOCAL tile's geometry (JAX's supports_geometry(...,
        # shards=))
        shards = self.tp_shards
        local_hq, local_hkv = model_cfg.num_heads // shards, model_cfg.num_kv_heads // shards
        self._page_kernel = self._paged and page_attention.supports_geometry(
            self._page, model_cfg.head_dim, local_hq, local_hkv, kv_dtype=cfg.kv_cache_dtype,
        )
        self._kv_kernel = (
            not self._paged and self._kv_quant and decode_attention.supported(
                self.max_seq_len, model_cfg.head_dim, local_hq, local_hkv,
            )
        )
        # the spec verify's K+1 query rows a slot through the page kernel
        self._spec_draft = spec_decode_mod.effective_draft_len(cfg)
        self._verify_kernel = self._paged and page_attention.supports_geometry(
            self._page, model_cfg.head_dim, local_hq, local_hkv,
            query_len=self._spec_draft + 1, kv_dtype=cfg.kv_cache_dtype,
        )
        # on the card a paged verify runs on the kernel or not at all; the
        # PP path serves no verify, as JAX's builds none
        self._spec_available = self._pp is None and not (
            self.device.type == "cuda" and self._paged and not self._verify_kernel
        )
        if self._pp is not None and cfg.spec_decode_enable == "on":
            logger.info("speculative decoding is built on the layered path only; the "
                        "pipeline-parallel path serves without it, as JAX's does")
        if self.device.type == "cuda":
            self._check_kernels(cfg, model_cfg, dtype)
        self._check_memory_budget(cfg, model_cfg)

        # what the checkpoint load read (peak_host_bytes, seconds); empty otherwise
        self.load_stats: Dict[str, float] = {}
        if params is None and cfg.checkpoint_path:
            # streamed: each layer transposed, quantized and placed (cut
            # into its shards under TP, onto its stage under PP) as its
            # tensors complete
            quantized = cfg.quantization in ("int8", "w8a8")
            t0 = time.time()
            if self._pp is not None:
                params = hf_loader.load_params_pp_streaming(
                    cfg.checkpoint_path, model_cfg, dtype, quantization=cfg.quantization,
                    ctx=self._pp, stats=self.load_stats,
                )
            else:
                params = hf_loader.load_params_layered_streaming(
                    cfg.checkpoint_path, model_cfg, dtype, quantization=cfg.quantization,
                    mesh=self._mesh, tp_shards=self.tp_shards if quantized else 1,
                    stats=self.load_stats,
                )
            self.load_stats["seconds"] = time.time() - t0
            logger.info("Loaded LLM weights (streaming) from %s", cfg.checkpoint_path)
        elif params is None:
            if cfg.quantization in ("int8", "w8a8"):
                params = quant.init_packed_params_int8(model_cfg, 0, dtype, self.device)
            else:
                params = llama.init_params(model_cfg, 0, dtype, self.device)
            logger.warning("LLM engine running with random-init weights (no checkpoint).")
        if self._pp is not None and not sharding.is_sharded(params):
            # a single-device tree, placed stage by stage (laid out per
            # shard and cut on stages of more than one shard)
            params = pp_serving.stage_params(params, self._pp, repack_cfg=model_cfg)
        elif self._tp is not None and not sharding.is_sharded(params):
            # a single-device tree, laid out per shard and cut: the same
            # function at every shard count
            params = sharding.shard_params(params, self._mesh, repack_cfg=model_cfg)
        self.params = params
        if self.device.type == "cuda":
            for pack in self._packs(params):
                if not int8_matmul.kernel_supported(pack["q"]):
                    raise ValueError(f"int8 pack {tuple(pack['q'].shape)} not served by the kernel")

        self._kv_alloc: Optional[kv_pages.PageAllocator] = None
        self._tables: Optional[torch.Tensor] = None
        if self._paged:
            self._cache = llama.init_kv_pool(
                model_cfg, self._pool_pages, self._page, dtype, self.device,
                quantized=self._kv_quant, packed=self._kv_packed, tp=self._tp,
            )
            self._kv_alloc = kv_pages.PageAllocator(self._pool_pages, self._page)
            self._tables = torch.zeros(
                (self.num_slots, self._max_pages_per_slot), dtype=torch.int32, device=self.device
            )
        elif self._pp is not None:
            self._cache = pp_serving.init_cache(
                model_cfg, self._pp, self.num_slots, self.max_seq_len, dtype,
                quantized=self._kv_quant,
            )
            self._pp_prefill = pp_serving.build_prefill(model_cfg, self._pp)
            self._pp_decode = pp_serving.build_decode_step(model_cfg, self._pp,
                                                           kv_kernel=self._kv_kernel)
            logger.info("PP serving: %d stages x TP=%d (%d layers/stage), kv=%s", self._pp.stages,
                        self._pp.tp, model_cfg.num_layers // self._pp.stages,
                        "int8" if self._kv_quant else "bf16")
        else:
            self._cache = llama.init_kv_cache_layers(
                model_cfg, self.num_slots, self.max_seq_len, dtype, self.device,
                quantized=self._kv_quant, tp=self._tp,
            )
        self._init_prefix_cache(cfg, model_cfg, dtype)
        self._stop_ids = set(self.tokenizer.stop_ids())
        self._dtype = dtype
        self._init_spec(cfg, draft_params)
        self._init_observability(cfg)
        # the chunked wave in flight (its requests), for the chunks' events
        self._chunk_reqs: Optional[List[_Request]] = None

        # Slot state on the device, patched per admission wave
        # (_update_slots) and read and written by every decode block: no
        # host round trip between blocks. Dead slots keep stale values;
        # _live_dev masks them (their positions read as 0).
        B, dev = self.num_slots, self.device
        self._tokens_dev = torch.zeros(B, dtype=torch.long, device=dev)
        self._positions_dev = torch.zeros(B, dtype=torch.long, device=dev)
        self._temps_dev = torch.ones(B, dtype=torch.float32, device=dev)
        self._topps_dev = torch.ones(B, dtype=torch.float32, device=dev)
        self._seeds_dev = torch.zeros(B, dtype=torch.long, device=dev)
        self._live_dev = torch.zeros(B, dtype=torch.bool, device=dev)

        # Slot bookkeeping: written by the dispatch thread only, under
        # self._lock; other threads (abort, the reader at shutdown, the
        # watchdog) read it under the lock.
        self._slot_req: Dict[int, _Request] = {}
        # disagg: slots the prefill tier claimed, held until the decode
        # tier imports their requests (the prefill tier writes, the
        # dispatch thread takes them out)
        self._tier_slots: Dict[int, _Request] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        # Host shadows: decode steps left before each slot's request
        # exhausts its budget, and each slot's decode position, both moved
        # by decode_block per dispatch. They free a slot without waiting
        # for its readback and pick the attention window.
        self._slot_budget: Dict[int, int] = {}
        self._slot_pos: Dict[int, int] = {}
        # every key exists up front: stats() copies these dicts from other
        # threads; the dispatch thread counts prefill, the reader decode.
        # Some of these events count in a registry family too: the families
        # are process-wide (JAX's names, summed over every engine of the
        # process: a router's replicas, a drain's target, a smoke's legs),
        # and stats() answers for this engine alone
        self._counters = collections.Counter(dict.fromkeys((
            "prefill_waves", "prefill_tokens", "prefill_chunks", "requests_prefilled",
            "prefix_copy_dispatches", "decode_dispatches", "spec_verify_dispatches",
            "spec_block_dispatches", "spec_pipeline_rollbacks", "spec_pipeline_confirmed",
        ), 0))
        self._reader_counters = collections.Counter(dict.fromkeys((
            "decode_blocks", "decode_steps", "decode_rows", "decode_row_dispatches",
            "decode_time_s", "tokens_generated", "readbacks",
        ), 0))
        self._ttft: "collections.deque[float]" = collections.deque(maxlen=4096)
        self._last_readback = 0.0  # reader thread: when the last readback completed

        self._lock = threading.Condition()
        self._pending: "collections.deque[_Request]" = collections.deque()  # guarded by self._lock
        self._paused = False  # guarded by self._lock; hold_admissions
        self._running = True  # guarded by self._lock
        self._last_progress = time.time()  # guarded by self._lock
        self._wedged = False
        # (kind, pinned host copy, its CUDA event or None, rows): the one
        # queue between the threads; put() on a full queue is the dispatch
        # thread's only backpressure
        self._readback: "queue.Queue[Optional[tuple]]" = queue.Queue(maxsize=cfg.decode_runahead)
        # (slot, request) the reader found finished; the dispatch loop frees them
        self._release_q: "queue.Queue[Tuple[int, _Request]]" = queue.Queue()
        # The drain state machine: _draining refuses submits and restores
        # and parks the dispatch loop at its next block boundary;
        # _drain_parked is the loop's acknowledgement, after which the
        # drain thread owns live request state.
        self._draining = False  # guarded by self._lock
        self._drain_parked = False  # guarded by self._lock
        # restores run on the dispatch thread, between decode blocks
        self._restore_q: "queue.Queue[tuple]" = queue.Queue()
        self._spool = request_snapshot_mod.SnapshotSpool(
            cfg.snapshot_spool_dir, cfg.snapshot_spool_max,
            fingerprint=provenance_mod.config_fingerprint(cfg),
        )
        # admission and wave formation (engine/scheduler/)
        self.scheduler = build_policy(cfg, self)
        # a replacement engine starts healthy, whatever an earlier one left
        ENGINE_WEDGED.clear()
        self._wd_stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="torch-llm-engine", daemon=True)
        self._reader = threading.Thread(target=self._reader_loop, name="torch-llm-reader", daemon=True)
        self._threads = [self._thread, self._reader]
        if cfg.watchdog_stall_s > 0:
            self._threads.append(threading.Thread(
                target=self._watchdog_loop, name="torch-llm-watchdog", daemon=True
            ))
        for thread in self._threads:
            thread.start()
        self.scheduler.start()

    def _init_observability(self, cfg: EngineConfig) -> None:
        """Gauges, the profiling labels and the dispatch timeline (each
        resolved once here: off means the dispatch sites run as before),
        and the utilization estimator."""
        _M_SLOTS_CAPACITY.set(self.num_slots)
        _M_SLOTS_IN_USE.set(0)
        _M_WEDGED.set(0)
        self._annotate = profiling.annotation_scope()
        self._dtl = dispatch_timeline_mod if dispatch_timeline_mod.enabled() else None
        # on the card a dispatch returns once launched: its host time is
        # the launch time, never a device-time estimate
        dispatch_timeline_mod.set_run_kind("launch" if self.device.type == "cuda" else "device_est")
        self._kv_byte_width = (
            hardware.kv_bytes_per_element(cfg.kv_cache_dtype) if self._kv_quant else 2
        )
        try:
            wbytes = hardware.streamed_weight_bytes(self.params)
        except Exception:  # noqa: BLE001 - a params tree the formula does not walk
            wbytes = 0
        self._telemetry = telemetry_mod.UtilizationEstimator(
            matmul_params=hardware.matmul_params(self.model_config),
            weight_stream_bytes=wbytes,
            # distinct cards: shards that share one share its peaks
            devices=len(self._mesh.distinct()),
        )

    # ------------------------------------------------------------------ #
    # build-time checks

    def _init_mesh(self, cfg: EngineConfig, model_cfg, device, mesh) -> None:
        """The engine's mesh and its TP or PP context. An explicit ``mesh``
        wins (its first device is the engine's); else ``device`` (one
        device) or, unset, the visible cards, as ``_resolve_parallelism``
        says. A ``pipe`` axis builds the PP context where
        ``pp_serving.supported`` holds; more than one shard on one stage
        builds the TP context where ``supports_model_config`` holds; each
        raises otherwise."""
        if mesh is None:
            dev = resolve_device(device)
            devices = [dev] if device is not None else mesh_mod.visible_devices()
            stages, tp = self._resolve_parallelism(cfg, model_cfg, devices)
            mesh = mesh_mod.create_mesh(tp, pipeline_parallelism=stages, devices=devices)
            # the first shard's device, by index: a thread's current device
            # may be another shard's while its kernels launch
            self.device = dev if device is not None else mesh.home
        else:
            self.device = resolve_device(mesh.home)
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device={device} is not the mesh's first device {self.device}")
        if mesh.data > 1 or mesh.seq > 1:
            raise ValueError(
                f"the engine serves the pipe and model axes; a mesh of data={mesh.data}, "
                f"seq={mesh.seq} is a training mesh (models/train.py)"
            )
        self._mesh = mesh
        self._tp: Optional[tp_kernels.TPContext] = None
        self._pp: Optional[pp_serving.PPContext] = None
        if mesh.pipe > 1:
            if not pp_serving.supported(model_cfg, mesh.pipe, mesh.tp):
                raise ValueError(
                    f"mesh pipe={mesh.pipe} x model={mesh.tp} does not divide this architecture"
                )
            self._pp = pp_serving.PPContext(
                mesh, mesh.pipe, mesh.tp, quant_kernel="w8a8" if cfg.quantization == "w8a8" else None,
                annotate=profiling.annotation_scope(),
            )
            logger.info("LLM engine mesh: %d stages x %d shards on %s", mesh.pipe, mesh.tp,
                        [str(d) for d in mesh.devices])
            return
        if mesh.size == 1:
            return
        if not tp_kernels.supports_model_config(model_cfg, mesh.size):
            raise ValueError(
                f"tensor_parallelism={mesh.size} does not divide {cfg.model_config_name} "
                f"(heads={model_cfg.num_heads}, kv_heads={model_cfg.num_kv_heads}, "
                f"intermediate={model_cfg.intermediate_size}, vocab={model_cfg.vocab_size})"
            )
        self._tp = tp_kernels.TPContext(mesh, mesh.size, annotate=profiling.annotation_scope())
        logger.info("LLM engine mesh: %d shards on %s", mesh.size, [str(d) for d in mesh.devices])

    @property
    def tp_shards(self) -> int:
        """Shards of the model axis (1 on one device; a stage's under PP)."""
        return self._mesh.tp

    def mesh_report(self) -> Dict[str, object]:
        """The mesh as served: its shards and devices, the peaks of its
        distinct cards together, and each device's memory (the fit plan's
        estimate beside what PyTorch holds there)."""
        memory = hardware.device_memory(self._mesh.devices)
        for dev, plan in self.memory_plan.items():
            memory[dev]["planned_bytes"] = int(plan)
        return {
            "shards": self._mesh.size,
            "stages": self._mesh.pipe,
            "devices": [str(d) for d in self._mesh.devices],
            "peaks": hardware.mesh_peaks(len(self._mesh.distinct())),
            "memory": memory,
        }

    def _per_device_memory(self, devices) -> float:
        """One device's memory, the fit plan's budget (JAX's
        ``_per_device_hbm``)."""
        return device_memory_bytes(devices[0])

    def _resolve_parallelism(self, cfg: EngineConfig, model_cfg, devices) -> tuple:
        """``(stages, tp)`` for mesh construction, JAX's rule at every
        branch. Explicit ``pipeline_parallelism`` wins (``tp`` -1 takes
        the devices each stage has). With the defaults (pp 1, tp -1) the
        fit plan picks PP when the architecture caps the model axis below
        the device count (``num_kv_heads`` caps TP) and the TP-only
        estimate exceeds the capped mesh's memory: ``(n // cap, cap)``
        over every device; where the capped mesh fits, ``(1, cap)`` (the
        spare devices idle); otherwise ``(1, tp)``, ``-1`` taking every
        device."""
        stages = max(1, cfg.pipeline_parallelism)
        tp, n = cfg.tensor_parallelism, len(devices)
        if stages > 1:
            if tp == -1:
                tp = max(1, n // stages)
            if not pp_serving.supported(model_cfg, stages, tp):
                raise ValueError(
                    f"pipeline_parallelism={stages} x tensor_parallelism="
                    f"{tp} does not divide this architecture "
                    f"(layers={model_cfg.num_layers}, kv_heads="
                    f"{model_cfg.num_kv_heads})"
                )
            return stages, tp
        if tp != -1 or n <= 1:
            return 1, tp
        tp_cap = pp_serving.max_tp(model_cfg, n)
        if tp_cap >= n or tp_cap < 1 or n % tp_cap:
            return 1, tp
        auto_stages = n // tp_cap
        if not pp_serving.supported(model_cfg, auto_stages, tp_cap):
            return 1, tp
        # the capped-TP path honours the configured KV dtype and builds the
        # prefix store; the PP path builds none, so only this estimate
        # counts its slots (JAX's rule)
        est = llama.serving_memory_bytes(
            model_cfg, cfg.max_batch_size + _prefix_store_extra_slots(cfg),
            min(cfg.max_seq_len, model_cfg.max_seq_len),
            weight_bytes=1 if cfg.quantization in ("int8", "w8a8") else 2,
            kv_bytes=hardware.kv_bytes_per_element(cfg.kv_cache_dtype),
        )
        if est["total"] > self._per_device_memory(devices) * tp_cap * 0.92:
            logger.warning(
                "TP is capped at %d by the architecture and the %.1f GB estimate exceeds that "
                "mesh's memory: pipeline_parallelism=%d x tensor_parallelism=%d over all %d "
                "devices", tp_cap, est["total"] / 1e9, auto_stages, tp_cap, n,
            )
            return auto_stages, tp_cap
        return 1, tp_cap

    def _check_memory_budget(self, cfg: EngineConfig, model_cfg) -> None:
        """Fit the weights and the KV cache per shard device (JAX's
        ``_check_memory_budget``, per device instead of in aggregate: the
        embedding stays whole on the first device). Logs the plan, warns
        where a device would run out; ``memory_plan`` keeps it."""
        shards = self._mesh.size
        act = 4 if cfg.dtype == "float32" else 2
        wbytes = 1 if cfg.quantization in ("int8", "w8a8") else act
        embed = model_cfg.vocab_size * model_cfg.hidden_size
        kv = llama.serving_memory_bytes(
            model_cfg, self.num_slots + _prefix_store_extra_slots(cfg), self.max_seq_len,
            weight_bytes=0, kv_bytes=hardware.kv_bytes_per_element(cfg.kv_cache_dtype),
        )["kv_cache"]
        share = ((llama.count_logical_params(model_cfg) - embed) * wbytes + kv) / shards
        plan: Dict[str, float] = {}
        for i, dev in enumerate(self._mesh.devices):
            # the embedding stays whole on the first device
            plan[str(dev)] = plan.get(str(dev), 0.0) + share + (embed * act if i == 0 else 0)
        self.memory_plan = plan
        for dev in self._mesh.distinct():
            need, have = plan[str(dev)], device_memory_bytes(dev) * 0.92
            logger.info("serving memory on %s: %.2f GB of ~%.1f GB usable", dev, need / 1e9, have / 1e9)
            if need > have:
                logger.warning(
                    "estimated %.1f GB on %s exceeds its ~%.1f GB usable memory; expect an "
                    "out-of-memory error (quantization=int8, kv_cache_dtype=int8 or more "
                    "shards reduce it)", need / 1e9, dev, have / 1e9,
                )

    def _check_kernels(self, cfg: EngineConfig, model_cfg, dtype) -> None:
        """On the card every kernel of the serving path must serve this
        geometry: a refusal is an error here, not a silent fall back."""
        if dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels serve dtype='bfloat16' only")
        if cfg.spec_decode_enable == "on" and not self._spec_available and self._paged:
            raise ValueError(
                f"paged attention kernel refuses the spec verify's "
                f"{self._spec_draft + 1} query rows x {model_cfg.num_heads} heads "
                f"(spec_draft_len {self._spec_draft}, at most "
                f"{page_attention.MAX_QUERY_ROWS} query rows)"
            )
        shards = self.tp_shards
        if self._paged and not self._page_kernel:
            raise ValueError(
                f"paged attention kernel refuses page_size={cfg.page_size} "
                f"head_dim={model_cfg.head_dim} heads={model_cfg.num_heads // shards} "
                f"kv_heads={model_cfg.num_kv_heads // shards} a shard "
                f"kv_cache_dtype={cfg.kv_cache_dtype}"
            )
        if not self._paged and self._kv_quant and not self._kv_kernel:
            raise ValueError(
                f"decode attention kernel refuses the int8 fixed cache max_seq_len="
                f"{self.max_seq_len} head_dim={model_cfg.head_dim} "
                f"heads={model_cfg.num_heads // shards} "
                f"kv_heads={model_cfg.num_kv_heads // shards} a shard"
            )
        bucket = min(cfg.prefill_chunk, self.max_seq_len)
        if bucket >= flash_attention.MIN_T and not flash_attention.supported(
            bucket, model_cfg.head_dim
        ):
            raise ValueError(f"flash attention kernel refuses head_dim={model_cfg.head_dim}")

    @staticmethod
    def _packs(params):
        """Every int8 pack of the tree, each shard's tile of a sharded one."""
        leaves = [v for lp in params["layers"] for v in lp.values()] + [params.get("lm_head")]
        for val in leaves:
            for piece in (val if isinstance(val, sharding.Shards) else [val]):
                if isinstance(piece, dict):
                    yield piece

    def _init_prefix_cache(self, cfg: EngineConfig, model_cfg, dtype) -> None:
        """The automatic prefix KV cache (JAX ``_init_prefix_cache``):
        ``prefix_cache_slots`` entries in a radix index. On the paged
        layout entries hold refcounted pool pages (the pool was sized
        with a strip per entry) and the drop hook releases them; on the
        fixed layout a store of one strip per entry, in the slot cache's
        layout, holds the rows. ``off`` or 0 slots leaves ``_prefix``
        None and admission as it is without a cache."""
        self._prefix: Optional[prefix_cache.PrefixCache] = None
        self._prefix_store: Optional[list] = None
        P = _prefix_store_extra_slots(cfg)
        if P <= 0 or self._pp is not None:  # JAX builds none on the PP path
            return
        if self._paged:
            self._prefix = prefix_cache.PrefixCache(
                chunk=cfg.prefill_chunk, slots=P, max_len=self.max_seq_len,
                on_drop=self._drop_prefix_pages,
            )
            logger.info(
                "prefix KV cache enabled (paged, shared pages): %d entries, %.2f GiB of "
                "the %d-page pool (chunk %d)",
                P, self.prefix_cache_bytes() / 2**30, self._pool_pages, cfg.prefill_chunk,
            )
            return
        self._prefix_store = llama.init_kv_cache_layers(
            model_cfg, P, self.max_seq_len, dtype, self.device, quantized=self._kv_quant,
            tp=self._tp,
        )
        self._prefix = prefix_cache.PrefixCache(
            chunk=cfg.prefill_chunk, slots=P, max_len=self.max_seq_len
        )
        logger.info(
            "prefix KV cache enabled: %d store slots x %d rows, %.2f GiB (chunk %d)",
            P, self.max_seq_len, self.prefix_cache_bytes() / 2**30, cfg.prefill_chunk,
        )

    def prefix_cache_bytes(self) -> int:
        """Device bytes the prefix cache reserves: the fixed layout's store,
        or on the paged layout the pool pages of one strip per entry."""
        if self._prefix is None:
            return 0
        if self._prefix_store is not None:
            return sum(t.numel() * t.element_size() for t in _cache_tensors(self._prefix_store))
        return self._prefix.capacity * self._max_pages_per_slot * self._page_bytes()

    def _drop_prefix_pages(self, entry: prefix_cache.PrefixEntry) -> None:
        """Prefix-cache drop hook (paged layout): an entry leaving the
        index releases its refcounted pool pages. Runs under the index's
        lock; the allocator has its own and never calls back."""
        if entry.pages:
            self._kv_alloc.release(entry.pages)
        entry.pages = None

    def _init_spec(self, cfg: EngineConfig, draft_params=None) -> None:
        """Speculative decoding's state (JAX ``_build_steps_layered``'s spec
        half, ``_init_spec_proposer`` and ``_init_scheduler_state``'s
        fields): the proposer (lookup, or the resident draft model built
        here for the draft-model kinds), the adaptive width, the per-slot
        proposer contexts and the pipelined verify's state."""
        self._spec_ngram = max(1, cfg.spec_ngram_max)
        self._adaptive_k: Optional[spec_decode_mod.AdaptiveK] = None
        if cfg.spec_adaptive_k == "on":
            self._adaptive_k = spec_decode_mod.AdaptiveK(
                self._spec_draft, k_min=cfg.spec_adaptive_k_min,
                threshold=cfg.spec_adaptive_k_threshold,
            )
        self._spec_enabled = cfg.spec_decode_enable == "on" and self._spec_available
        # 'off' pins every spec round to the synchronous path
        self._spec_pipeline = cfg.spec_pipeline_enable != "off"
        # dispatch thread only: the verify in flight (its host copy, event
        # and what landing it needs), and the (confirmed, missed) runahead
        # drafts its flush left for the next round
        self._spec_pending: Optional[dict] = None
        self._spec_reconcile: Optional[tuple] = None
        # each drafting slot's prompt + output, the proposers' context:
        # seeded at admission, extended after each landed spec round,
        # dropped at release (dispatch thread, or a thread that owns the
        # slot while the loop is parked)
        self._spec_ctx: Dict[int, List[int]] = {}
        self._draft = None
        self._draft_params = draft_params
        self._spec_proposer: Optional[spec_decode_mod.SpecProposer] = None
        if not self._spec_available:
            return
        if cfg.spec_proposer == "lookup":
            self._spec_proposer = spec_decode_mod.LookupProposer(self._spec_ngram)
            return
        self._draft = self._build_draft_runtime(cfg)
        if cfg.spec_proposer == "draft_model":
            self._spec_proposer = spec_decode_mod.DraftModelProposer(self._draft)
        else:
            self._spec_proposer = spec_decode_mod.CombinedProposer(self._spec_ngram, self._draft)

    def _build_draft_runtime(self, cfg: EngineConfig):
        from generativeaiexamples_tpu_torch.engine import spec_draft

        return spec_draft.DraftRuntime(
            cfg, device=self.device, dtype=self._dtype, sample_vocab=self._sample_vocab,
            num_slots=self.num_slots, max_seq_len=self.max_seq_len, params=self._draft_params,
            mesh=self._mesh,
        )

    def set_spec_decode(self, enabled: bool) -> bool:
        """Turn speculative decoding on or off while serving; returns the
        state in effect (False where the verify cannot run: a paged engine
        on the card whose page kernel refuses K+1 query rows). The flag
        picks the program of the next dispatch; rows admitted while spec
        was off have no context and never draft until their slot
        recycles."""
        with self._lock:
            self._spec_enabled = bool(enabled) and self._spec_available
            if not self._spec_enabled:
                # contexts stop tracking emissions under block decode
                self._spec_ctx.clear()
                if self._spec_proposer is not None:
                    self._spec_proposer.reset()
                self._spec_reconcile = None
            return self._spec_enabled

    def set_spec_proposer(self, kind: str) -> Optional[str]:
        """Switch the proposer while serving (``lookup``, ``draft_model``,
        ``combined``); returns the kind in effect, or None where there is
        no verify or no draft model is configured. The draft model is built
        on the first switch to it."""
        if not self._spec_available:
            return None
        cfg = self.engine_config
        if kind == "lookup":
            prop = spec_decode_mod.LookupProposer(self._spec_ngram)
        elif kind in ("draft_model", "combined"):
            if self._draft is None:
                if not (cfg.spec_draft_model or cfg.spec_draft_checkpoint_path):
                    return None
                self._draft = self._build_draft_runtime(cfg)
            if kind == "draft_model":
                prop = spec_decode_mod.DraftModelProposer(self._draft)
            else:
                prop = spec_decode_mod.CombinedProposer(self._spec_ngram, self._draft)
        else:
            raise ValueError(
                f"spec proposer must be one of "
                f"{'|'.join(spec_decode_mod.PROPOSER_KINDS)}, got {kind!r}"
            )
        with self._lock:
            # contexts and frontiers follow the old proposer's rule
            if self._spec_proposer is not None:
                self._spec_proposer.reset()
            self._spec_ctx.clear()
            self._spec_reconcile = None
            self._spec_proposer = prop
        return prop.kind

    # ------------------------------------------------------------------ #
    # public API

    def submit(self, prompt_ids: Sequence[int], params: Optional[SamplingParams] = None) -> _Request:
        """Submit a request; returns its handle. Over-long prompts keep
        their tail, with room for at least min(64, max_tokens) tokens.
        Raises ``EngineOverloaded`` when ``max_queued_requests`` requests
        already wait for a slot, or while the engine drains."""
        params = params or SamplingParams()
        reserve = max(1, min(64, params.max_tokens))
        keep = max(1, self.max_seq_len - 1 - reserve)
        req = _Request(
            rid=next(_REQ_IDS),
            prompt_ids=list(prompt_ids)[-keep:],
            params=params,
            sampling_seed=params.seed or _UNSEEDED_RNG.getrandbits(31),
            t_submit=time.time(),
            trace_hex=metrics_mod.current_trace_id_hex(),
        )
        if self._prefix is not None and params.prefix_hint:
            # session keep-alive: the hinted entry's recency is bumped
            # before admission, so other traffic cannot evict it meanwhile
            self._prefix.touch(params.prefix_hint)
        self._map_flight(req)
        if req.flight_rec is not None:
            req.flight_rec.event("submit", rid=req.rid, prompt_tokens=len(req.prompt_ids))
        cap = self.engine_config.max_queued_requests
        with self._lock:
            if not self._running:
                flight_recorder.finish_rid(req.rid, "shutdown")
                raise RuntimeError("LLM engine is shut down")
            if self._draining:
                # new work goes to another replica (the same 429 path)
                flight_recorder.event("engine_draining", pending=len(self._pending))
                flight_recorder.finish_rid(req.rid, "overload")
                raise EngineOverloaded("engine draining — checkpoint/handover in progress")
            if cap > 0 and len(self._pending) >= cap:
                _M_OVERLOAD.inc()
                flight_recorder.event("engine_overloaded", pending=len(self._pending), cap=cap)
                flight_recorder.finish_rid(req.rid, "overload")
                raise EngineOverloaded(
                    f"engine admission queue full ({len(self._pending)}/{cap} pending)"
                )
            self._pending.append(req)
            _M_QUEUE_DEPTH.set(len(self._pending))
            _M_REQUESTS.inc()
            self._lock.notify_all()
        return req

    @staticmethod
    def _map_flight(req: _Request) -> None:
        """Map the rid to the calling thread's flight record (a server
        request's), or to an engine-owned one retired when the rid
        finishes; before the request is visible to the dispatch thread."""
        if not flight_recorder.enabled():
            return
        rec = flight_recorder.current()
        if rec is None:
            rec = flight_recorder.start(trace_id=req.trace_hex, owner="engine")
        flight_recorder.map_rid(req.rid, rec)
        req.flight_rec = rec

    def queue_depth(self) -> int:
        """Requests awaiting admission (the server's shedding signal)."""
        with self._lock:
            return len(self._pending)

    def abort(self, handle) -> bool:
        """Abort a request by handle (the ``submit()`` return) or rid: a
        pending one ends at once, a slotted one is released by the dispatch
        loop's next pass. False when the request is unknown, already
        finished or already aborted."""
        with self._lock:
            if isinstance(handle, _Request):
                req = handle
            else:
                rid = int(handle)
                req = next((r for r in self._pending if r.rid == rid), None) or next(
                    (r for r in self._slot_req.values() if r.rid == rid), None
                ) or next(
                    (r for r in self._tier_slots.values() if r.rid == rid), None
                )
            if req is None or req.finished or req.cancelled:
                return False
            req.cancelled = True
            _M_ABORTS.inc()
            flight_recorder.event_rid(req.rid, "abort", slotted=req.slot >= 0)
            if req in self._pending:
                self._pending.remove(req)
                _M_QUEUE_DEPTH.set(len(self._pending))
                self._finish(req)
            self._lock.notify_all()
            return True

    def generate_ids(
        self, prompt_ids: Sequence[int], params: Optional[SamplingParams] = None
    ) -> "queue.Queue[Optional[int]]":
        """Submit a request; returns the queue of generated token ids
        (``None`` ends it)."""
        return self.submit(prompt_ids, params).out_queue

    def iter_ids(
        self,
        prompt_ids: Sequence[int],
        params: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
    ) -> Generator[int, None, None]:
        """Submit and yield generated ids. ``timeout=None`` applies
        ``stream_timeout_s`` per awaited token; an explicit ``timeout`` is
        a whole-stream budget."""
        stall_s = float(self.engine_config.stream_timeout_s) if timeout is None else None
        req = self.submit(prompt_ids, params)
        deadline = None if timeout is None else time.time() + timeout
        try:
            while True:
                item = _next_stream_item(req.out_queue, stall_s, deadline)
                if item is _END:
                    if isinstance(req.error, RequestPreempted):
                        raise req.error
                    if req.error is not None:
                        raise RuntimeError("LLM engine failed") from req.error
                    return
                yield item
        finally:
            self.abort(req)

    def stream_text(
        self,
        prompt_ids: Sequence[int],
        params: Optional[SamplingParams] = None,
        timeout: Optional[float] = None,
    ) -> Generator[str, None, None]:
        """Generate and yield incremental detokenized text. The submit is
        eager, so a shut-down engine raises at the call site."""
        params = params or SamplingParams()
        req = self.submit(prompt_ids, params)
        gen = self._stream_from(req, params, timeout)
        # a generator closed before its first next() skips its finally
        weakref.finalize(gen, self.abort, req)
        return gen

    def _stream_from(self, req: _Request, params: SamplingParams, timeout: Optional[float],
                     prior_ids: Sequence[int] = ()):
        # a restored request decodes its first delta over the spooled ids
        # too: the client gets the whole prefix with exact tokenization
        # boundaries
        ids: List[int] = list(prior_ids)
        emitted = ""
        stops = [s for s in params.stop if s]
        stall_s = float(self.engine_config.stream_timeout_s) if timeout is None else None
        deadline = None if timeout is None else time.time() + timeout
        try:
            while True:
                item = _next_stream_item(req.out_queue, stall_s, deadline)
                if item is _END:
                    if isinstance(req.error, RequestPreempted):
                        raise req.error
                    if req.error is not None:
                        raise RuntimeError("LLM engine failed") from req.error
                    # flush a tail held back as an incomplete UTF-8 sequence
                    text = self.tokenizer.decode(ids)
                    if len(text) > len(emitted):
                        found = [i for i in (text.find(s) for s in stops) if i != -1]
                        cut = min(found) if found else len(text)
                        if cut > len(emitted):
                            yield text[len(emitted):cut]
                    return
                ids.append(item)
                text = self.tokenizer.decode(ids)
                if text.endswith("�"):  # mid-codepoint; wait for more bytes
                    continue
                delta = text[len(emitted):]
                if not delta:
                    continue
                candidate = emitted + delta
                found = [i for i in (candidate.find(s) for s in stops) if i != -1]
                if found:
                    final = candidate[: min(found)]
                    if len(final) > len(emitted):
                        yield final[len(emitted):]
                    return
                emitted = candidate
                yield delta
        finally:
            self.abort(req)

    def chat(
        self, messages: Sequence[Tuple[str, str]], params: Optional[SamplingParams] = None
    ) -> Generator[str, None, None]:
        """Render the chat template and stream the completion."""
        return self.stream_text(self.tokenizer.render_chat(messages), params)

    def is_decoding(self) -> bool:
        """Whether any request currently occupies a decode slot (the
        embedder's synchronous ingestion throttle polls this)."""
        with self._lock:
            return bool(self._slot_req)

    def hold_admissions(self):
        """Context manager: pause admissions while requests enqueue, so the
        dispatch thread sees them all at once and admits one full wave."""
        engine = self

        class _Hold:
            def __enter__(self):
                with engine._lock:
                    engine._paused = True

            def __exit__(self, *exc):
                with engine._lock:
                    engine._paused = False
                    engine._lock.notify_all()
                return False

        return _Hold()

    # ------------------------------------------------------------------ #
    # preemption: drain with checkpoints, restore elsewhere

    @property
    def snapshot_spool(self) -> request_snapshot_mod.SnapshotSpool:
        """The engine's snapshot spool (fingerprint-stamped at build)."""
        return self._spool

    def is_draining(self) -> bool:
        with self._lock:
            return self._draining

    def drain(self, timeout: Optional[float] = None) -> Dict[str, object]:
        """Quiesce the engine and checkpoint every in-flight request.

        In order: flip ``_draining`` (submits and restores refuse, the
        prefill tier stops claiming, the dispatch loop parks at its next
        block boundary); wait for the park and no prefill wave in flight;
        push a barrier through the readback queue, so every dispatched
        block is emitted and each request's position and transcript are
        current; then capture the queued handoffs and the slotted requests
        with their KV pages into the spool, fail their streams with
        ``RequestPreempted`` carrying the snapshot id, and release their
        slots and pages. A request with no KV to carry (unadmitted, the
        fixed layout, a missed park) is preempted replay-only.

        Runs on the caller's thread within ``drain_timeout_s`` (or
        ``timeout``); returns the summary the drain route answers."""
        budget_s = float(self.engine_config.drain_timeout_s if timeout is None else timeout)
        deadline = time.time() + budget_s
        flight_recorder.event("drain_begin", timeout_s=round(budget_s, 3))
        with self._lock:
            self._draining = True
            self._paused = True
            self._lock.notify_all()
            while self._running and (
                not self._drain_parked or self.scheduler.wave_inflight() > 0
            ):
                if time.time() >= deadline:
                    break
                self._lock.wait(timeout=0.05)
            parked = self._drain_parked and self.scheduler.wave_inflight() == 0
        # queued restores cannot run on a parked loop: their waiters replay
        while True:
            try:
                entry = self._restore_q.get_nowait()
            except queue.Empty:
                break
            entry[3]["mode"] = "replay_needed"
            entry[3]["event"].set()
        if parked:
            barrier = threading.Event()
            self._readback.put(("drain_barrier", barrier, None, None))
            if not barrier.wait(timeout=max(0.05, deadline - time.time())):
                logger.error("drain readback barrier missed the deadline; "
                             "falling back to replay-only checkpoints")
                parked = False
        if not parked:
            logger.error("engine did not park within the %.1f s drain budget; in-flight "
                         "requests are preempted replay-only (prompt + pinned seed)", budget_s)
        # the reader's releases wait while the loop is parked: a request
        # that finished is released, not checkpointed
        self._drain_releases()
        with self._lock:
            handoff_victims = self.scheduler.drain_handoffs()
            slot_victims = []
            for slot, req in list(self._slot_req.items()):
                if req.finished:
                    self._release(slot, req)
                else:
                    slot_victims.append((req, slot))
            pending = list(self._pending)
            self._pending.clear()
        snapshots: List[str] = []
        replayed = completed = 0

        def preempt(req: _Request, position: int, pages) -> None:
            nonlocal replayed
            cap_pos = position if (parked and pages and req.emitted) else 0
            snap = request_snapshot_mod.capture(self, req, cap_pos, pages if cap_pos else ())
            sid: Optional[str] = None
            if snap.restorable:
                try:
                    self._spool.save(snap)
                    sid = snap.snapshot_id
                    snapshots.append(sid)
                except OSError as exc:
                    logger.error("snapshot spool write failed for rid %d: %s", req.rid, exc)
            mode = "snapshot" if sid else "replay"
            if sid is None:
                replayed += 1
            request_snapshot_mod.record_preempted(mode)
            flight_recorder.event_rid(req.rid, "preempt", mode=mode, snapshot=sid or "",
                                      position=position, generated=req.generated)
            req.error = RequestPreempted(f"request preempted by engine drain ({mode})",
                                         snapshot_id=sid)
            self._finish(req)

        for rec in handoff_victims:
            req = rec.req
            if req.finished or req.cancelled:
                self._finish(req)
                completed += 1
            else:
                with self._lock:
                    pages = tuple(self._slot_pages.get(rec.slot, ()))
                preempt(req, int(rec.position), pages)
            self._import_handoff(rec)  # finished now: gives back slot and pages
        for req, slot in slot_victims:
            if req.cancelled:
                self._finish(req)
                completed += 1
            else:
                with self._lock:
                    pages = tuple(self._slot_pages.get(slot, ()))
                preempt(req, int(req.position), pages)
            self._release(slot, req)
        for req in pending:
            # never admitted: replay-only
            if req.cancelled or req.finished:
                self._finish(req)
                completed += 1
            else:
                preempt(req, 0, ())
        summary: Dict[str, object] = {
            "draining": True, "parked": parked,
            "preempted": len(snapshots) + replayed, "spooled": len(snapshots),
            "snapshots": snapshots, "replay_only": replayed, "completed": completed,
        }
        flight_recorder.event("drain_complete", spooled=len(snapshots), replay_only=replayed,
                              parked=parked)
        logger.warning("engine drained: %d spooled, %d replay-only, %d completed (parked=%s)",
                       len(snapshots), replayed, completed, parked)
        return summary

    def resume_from_drain(self) -> None:
        """Lift a drain: admission reopens and the dispatch loop resumes."""
        with self._lock:
            self._draining = False
            self._drain_parked = False
            self._paused = False
            self._lock.notify_all()
        logger.warning("engine drain lifted; admission reopened")

    def restore_snapshot(self, snap) -> Tuple[_Request, SamplingParams, List[int], str]:
        """Re-admit a spooled snapshot on this engine; returns ``(req,
        params, prior_ids, mode)``. Mode "restore" resumes decode at the
        snapshot's position with its KV (stream it with
        ``stream_restored``, which re-delivers the spooled tokens first);
        "replay" regenerates from the prompt under the pinned seed (no
        payload, the fixed layout, or no free slot or pages). Raises
        ``SnapshotMismatch`` on a config-fingerprint or KV-geometry
        mismatch and ``EngineOverloaded`` while this engine drains. A
        snapshot restores at any shard count: its payload holds the full
        model's heads, split over this engine's shards here."""
        t0 = time.time()
        self._spool.check_fingerprint(snap)
        request_snapshot_mod.check_geometry(self, snap)
        params = snap.sampling_params()
        with self._lock:
            if self._draining:
                raise EngineOverloaded("engine draining — cannot accept restores")
        if not (self._paged and snap.restorable and snap.emitted and snap.position > 0):
            req = self.submit(snap.prompt_ids, params)
            request_snapshot_mod.record_restored("replay")
            flight_recorder.event_rid(req.rid, "restore", snapshot=snap.snapshot_id, mode="replay")
            return req, params, [], "replay"
        payload = request_snapshot_mod.decode_kv_payload(snap.kv)
        req = _Request(rid=next(_REQ_IDS), prompt_ids=list(snap.prompt_ids), params=params,
                       sampling_seed=int(snap.sampling_seed), t_submit=time.time(),
                       trace_hex=metrics_mod.current_trace_id_hex())
        req.emitted = list(snap.emitted)
        req.generated = len(req.emitted)
        req.position = int(snap.position)
        self._map_flight(req)
        result: Dict[str, object] = {"event": threading.Event(), "mode": None, "error": None}
        with self._lock:
            self._restore_q.put((snap, payload, req, result))
            self._lock.notify_all()
        if not result["event"].wait(timeout=float(self.engine_config.drain_timeout_s)):
            flight_recorder.finish_rid(req.rid, "error")
            raise TimeoutError("restore was not picked up by the dispatch loop")
        if result["error"] is not None:
            flight_recorder.finish_rid(req.rid, "error")
            raise result["error"]  # type: ignore[misc]
        if result["mode"] != "restore":
            # no free slot or pages now: a replay through normal admission
            flight_recorder.finish_rid(req.rid, "restore_replay")
            req2 = self.submit(snap.prompt_ids, params)
            request_snapshot_mod.record_restored("replay")
            flight_recorder.event_rid(req2.rid, "restore", snapshot=snap.snapshot_id,
                                      mode="replay")
            return req2, params, [], "replay"
        request_snapshot_mod.record_restored("restore", time.time() - t0)
        flight_recorder.event_rid(req.rid, "restore", snapshot=snap.snapshot_id, mode="restore",
                                  position=req.position, emitted=req.generated)
        return req, params, list(snap.emitted), "restore"

    def stream_restored(self, req: _Request, params: SamplingParams, prior_ids: Sequence[int],
                        timeout: Optional[float] = None) -> Generator[str, None, None]:
        """Stream a restored request: the spooled transcript seeds the
        detokenizer, so the first delta is the whole spooled prefix plus
        the new text."""
        gen = self._stream_from(req, params, timeout, prior_ids=prior_ids)
        weakref.finalize(gen, self.abort, req)
        return gen

    def stats(self) -> Dict[str, float]:
        """Serving counters: prefill waves, tokens (whole prompts, cached
        prefixes included) and chunks, and the requests prefilled (each
        admitted request once); the prefix cache's hits, misses,
        evictions, tokens reused, pages mapped (paged) and store copies
        (fixed, ``prefix_copy_dispatches``); decode
        blocks, steps, rows, row dispatches (the live rows of each
        dispatch) and wall time; tokens emitted; TTFTs (submit to the
        reader's emission of the first token); on the paged layout,
        the page allocator's state; and speculative decoding's counters:
        ``decode_dispatches`` (decode blocks, verifies and zero-draft
        blocks), ``spec_verify_dispatches``, ``spec_block_dispatches``,
        the pipeline's confirmed and rolled-back runahead drafts, the
        draft-aware skips and JAX's ``spec_*`` keys (process-wide, as
        JAX's families are). A verify counts in the reader's decode
        counters as one block of one step.

        The reader counts a decode block when its token slab is read back,
        and ``decode_time_s`` adds, for each block, the wall time from its
        dispatch, or from the previous readback's completion if that came
        later, to its own readback's completion: the time the user waits
        for decode blocks, device work included, with prefill readbacks
        and idle gaps left out."""
        out: Dict[str, float] = dict(self._counters)
        out.update(self._reader_counters)
        ttft = list(self._ttft)
        if ttft:
            out["ttft_mean_s"] = sum(ttft) / len(ttft)
            out["ttft_max_s"] = max(ttft)
        if self._kv_alloc is not None:
            out.update(self._kv_alloc.stats())
        pc = self._prefix.stats() if self._prefix is not None else {}
        for key in ("hits", "misses", "evictions", "tokens_reused"):
            out["prefix_cache_" + key] = pc.get(key, 0)
        out.setdefault("prefix_pages_mapped", 0)
        # process-wide, as JAX's families are: read deltas
        out.update(spec_decode_mod.metrics_snapshot())
        out["spec_draft_skips"] = self.scheduler.draft_skips
        out["tp_shards"] = self.tp_shards
        out["pp_stages"] = self._mesh.pipe
        return out

    @property
    def metrics(self) -> Dict[str, float]:
        """JAX's flat view over the registry families (``/internal/metrics``
        serves it). The families are process-wide, so values add up
        across engines of one process: read deltas."""
        from generativeaiexamples_tpu_torch.engine.scheduler import base as scheduler_base

        rb_prefill = _M_READBACK.labels(kind="prefill")
        rb_decode = _M_READBACK.labels(kind="decode")
        out: Dict[str, float] = {
            "prefix_cache_hits": prefix_cache._M_HITS.value,
            "prefix_cache_misses": prefix_cache._M_MISSES.value,
            "prefix_cache_evictions": prefix_cache._M_EVICTIONS.value,
            "prefix_cache_tokens_reused": prefix_cache._M_TOKENS_REUSED.value,
            "kv_page_allocs": kv_pages._M_ALLOCS.value,
            "kv_page_frees": kv_pages._M_FREES.value,
            "kv_page_alloc_failures": kv_pages._M_ALLOC_FAILURES.value,
            "kv_prefix_pages_mapped": kv_pages._M_PREFIX_MAPPED.value,
            "kv_pages_in_use": kv_pages._M_POOL_IN_USE.value,
            "kv_page_utilization": kv_pages._M_POOL_UTIL.value,
        }
        out.update(spec_decode_mod.metrics_snapshot())
        out.update(handoff_mod.metrics_snapshot())
        out["spec_draft_skips"] = scheduler_base._M_SPEC_DRAFT_SKIPS.value
        out.update({
            "prefix_copy_dispatches": _M_PREFIX_COPY.value,
            "paged_attn_kernel_dispatches": _M_PAGED_ATTN.labels(path="kernel").value,
            "paged_attn_gather_dispatches": _M_PAGED_ATTN.labels(path="gather").value,
            "generated_tokens": _M_TOKENS.value,
            "requests": _M_REQUESTS.value,
            "decode_steps": _M_DECODE_STEPS.value,
            "decode_dispatches": _M_DECODE_DISPATCHES.value,
            "admission_waves": _M_WAVES.value,
            "prefill_chunks": _M_PREFILL_CHUNKS.value,
            "queue_wait_sum": _M_QUEUE_WAIT.sum,
            "queue_wait_n": _M_QUEUE_WAIT.count,
            "ttft_sum": _M_TTFT.sum,
            "ttft_n": _M_TTFT.count,
            "prefill_wait_sum": _M_PREFILL_WAIT.sum,
            "readback_prefill_wait_sum": rb_prefill.sum,
            "readback_prefill_n": rb_prefill.count,
            "readback_decode_wait_sum": rb_decode.sum,
            "readback_decode_n": rb_decode.count,
            "spec_pipeline_rollbacks": _M_SPEC_PIPE_ROLLBACKS.value,
            "spec_pipeline_confirmed": _M_SPEC_PIPE_CONFIRMED.value,
        })
        out.update(dispatch_timeline_mod.counters_snapshot())
        return out

    def utilization_snapshot(self) -> Dict[str, float]:
        """The rolling-window MFU / HBM-roofline view against the H100's
        peaks (engine/telemetry.py) and the timeline's bubble
        decomposition (``/internal/slo`` and black-box bundles read it).
        JAX adds its compile-path stats; the port compiles nothing at
        serving time."""
        out = self._telemetry.snapshot()
        if self._dtl is not None:
            out.update(self._dtl.bubble_snapshot())
        return out

    def shutdown(self, timeout: float = 60.0) -> bool:
        """Stop the dispatch, reader and watchdog threads; every live
        stream ends. Returns True when all of them exited within
        ``timeout``; otherwise logs the ones left and marks the engine
        wedged."""
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._wd_stop.set()
        deadline = time.time() + timeout
        for thread in self._threads:
            thread.join(max(0.0, deadline - time.time()))
        stuck = [t.name for t in self._threads if t.is_alive()]
        if stuck:
            logger.error("LLM engine shutdown left thread(s) %s running", ", ".join(stuck))
            self._mark_wedged(f"shutdown join timeout: {', '.join(stuck)}")
            return False
        # every stream has ended; the slots, their pages and prefix pins
        # go back (no thread of the engine runs any more)
        with self._lock:
            live = list(self._slot_req.items()) + list(self._tier_slots.items())
        for slot, req in live:
            self._release(slot, req, tier=True)
        return True

    # ------------------------------------------------------------------ #
    # watchdog thread

    def _mark_wedged(self, reason: str) -> None:
        self._wedged = True
        _M_WEDGED.set(1)
        ENGINE_WEDGED.set()
        logger.error("LLM engine wedged: %s", reason)
        # a wedged dispatch loop is an incident for the black box
        from generativeaiexamples_tpu_torch.utils import blackbox

        blackbox.notify_wedged(reason)

    def _clear_wedged(self) -> None:
        if self._wedged:
            self._wedged = False
            _M_WEDGED.set(0)
            ENGINE_WEDGED.clear()
            logger.warning("LLM engine dispatch loop recovered; wedged state cleared")

    def _watchdog_loop(self) -> None:
        """Mark the engine wedged while the dispatch loop has made no
        progress for longer than ``watchdog_stall_s`` with work
        outstanding (a hung device call, a deadlock), and clear the mark
        when it resumes."""
        threshold = float(self.engine_config.watchdog_stall_s)
        poll = max(0.05, min(1.0, threshold / 4))
        while not self._wd_stop.wait(timeout=poll):
            with self._lock:
                if not self._running:
                    return
                busy = bool(self._slot_req) or bool(self._pending)
                stall = time.time() - self._last_progress
            if busy and stall > threshold:
                if not self._wedged:
                    self._mark_wedged(
                        f"dispatch loop made no progress for {stall:.1f} s with work "
                        f"outstanding (threshold {threshold:.1f} s)"
                    )
            else:
                self._clear_wedged()

    # ------------------------------------------------------------------ #
    # dispatch thread: chains device work and hands result handles to the
    # reader; it never waits for the device. The marker puts everything
    # reachable from here under the dispatch-readback lint.

    def _loop(self) -> None:  # genai-lint: dispatch-root
        while True:
            with self._lock:
                while self._running and (
                    # a drain: once parked, stay parked until resume or
                    # shutdown (the drain thread owns live state)
                    self._drain_parked if self._draining else (
                        not self.scheduler.has_work() and not self._slot_req
                        and self._release_q.empty() and self._restore_q.empty()
                    )
                ):
                    self._last_progress = time.time()  # waiting idle is progress
                    self._lock.wait(timeout=1.0)
                running = self._running
                parking = self._draining and not self._drain_parked
                self._last_progress = time.time()
            if not running:
                break
            if parking:
                # land the verify in flight, so its tokens reach the reader
                # ahead of the drain's barrier; no dispatch runs past here
                # until resume or shutdown
                if self._spec_pending is not None:
                    self._flush_spec_pipeline()
                with self._lock:
                    self._drain_parked = True
                    self._lock.notify_all()
                continue
            try:
                faults_mod.fault_point("engine.dispatch")
                # a 'kill' rule here dies mid-decode, as a preempted VM does
                faults_mod.fault_point("replica.kill")
                with torch.inference_mode():
                    self._drain_releases()
                    self._process_restores()
                    self._admit()
                    if self._slot_req:
                        self._decode_once()
            except Exception as exc:  # noqa: BLE001 - the serving loop must survive
                logger.exception("LLM engine dispatch error: %s", exc)
                with self._lock:
                    live = list(self._slot_req.items())
                for slot, req in live:
                    req.error = exc
                    self._finish(req)
                    self._release(slot, req)
        # the verify in flight lands first: its tokens reach the reader
        # ahead of the end
        if self._spec_pending is not None:
            try:
                self._flush_spec_pipeline()
            except Exception as exc:  # noqa: BLE001 - the shutdown must go on
                logger.exception("spec pipeline flush at shutdown failed: %s", exc)
        # the prefill tier stops before the reader does: its last wave's
        # first tokens still reach the reader
        self.scheduler.stop()
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
            for rec in self.scheduler.drain_handoffs():
                self._finish(rec.req)
            pending += list(self._tier_slots.values())
        for req in pending:
            self._finish(req, "shutdown")
        # outside the lock: with a full readback queue the reader needs the
        # lock (in _emit) to drain it
        self._readback.put(None)  # the reader ends every live stream and exits

    def _drain_releases(self) -> None:
        while True:
            try:
                slot, req = self._release_q.get_nowait()
            except queue.Empty:
                return
            self._release(slot, req)

    def _process_restores(self) -> None:
        """Serve queued snapshot restores (dispatch thread): a restored
        slot's device writes and its registration land between decode
        blocks."""
        while True:
            try:
                snap, payload, req, result = self._restore_q.get_nowait()
            except queue.Empty:
                return
            try:
                result["mode"] = self._apply_restore(snap, payload, req)
            except Exception as exc:  # noqa: BLE001 - reported to the waiter
                logger.exception("snapshot %s restore failed: %s", snap.snapshot_id, exc)
                result["error"] = exc
            finally:
                result["event"].set()

    def _apply_restore(self, snap, payload, req: _Request) -> str:
        """Re-admit one decoded snapshot (dispatch thread): "restore", or
        "replay_needed" when no slot or pages are free.

        The device state rebuilt: KV rows [0, position) from the payload
        (scattered into fresh pages of every layer's pool and scale
        planes), the slot's next input ``emitted[-1]`` at ``position``,
        its sampling state; rows past ``position`` are stale until
        written, as in a recycled slot."""
        page = self._page
        pos = int(snap.position)
        n_payload = int((snap.geometry or {}).get("pages") or 0)
        with self._lock:
            if not self._free_slots:
                return "replay_needed"
            slot = self._free_slots.pop()
        total = max(n_payload, kv_pages.pages_needed(
            pos, max(1, req.params.max_tokens - req.generated), page,
            self.max_seq_len, self._page_slack,
        ))
        pages = self._kv_alloc.alloc(total, count_failure=False)
        while pages is None and self._prefix is not None and self._prefix.evict_lru():
            pages = self._kv_alloc.alloc(total, count_failure=False)
        if pages is None:
            self._kv_alloc.record_alloc_failure()
            with self._lock:
                self._free_slots.append(slot)
            return "replay_needed"
        row = np.zeros((1, self._max_pages_per_slot), np.int32)
        row[0, : len(pages)] = pages
        slots = self._to_device([slot], torch.long)
        self._tables[slots] = self._to_device(row, torch.int32)
        request_snapshot_mod.write_pages(self, pages[:n_payload], payload)
        self._update_slots(
            slots, self._to_device([req.emitted[-1]], torch.long),
            self._to_device([pos], torch.long),
            self._to_device([req.params.temperature], torch.float32),
            self._to_device([req.params.top_p], torch.float32),
            self._to_device([req.sampling_seed & 0x7FFFFFFF], torch.long),
        )
        # at least one step: the reader's done check then ends the stream
        budget = max(1, min(req.params.max_tokens - req.generated, self.max_seq_len - 1 - pos))
        # a host proposer rebuilds its context from the transcript; the
        # draft model's KV is not in the snapshot, so under it a restored
        # row rides the verifies as a single-token row
        prop = self._spec_proposer
        spec_tokens = None
        if (self._spec_enabled and prop is not None and not prop.uses_draft_model
                and prop.eligible(req.params)):
            spec_tokens = list(req.prompt_ids) + list(req.emitted)
        with self._lock:
            if spec_tokens is not None:
                self._spec_ctx[slot] = spec_tokens
            req.slot = slot
            self._slot_pages[slot] = list(pages)
            self._slot_req[slot] = req
            self._slot_budget[slot] = budget
            self._slot_pos[slot] = pos
            self._lock.notify_all()
        return "restore"

    def _stage(self, host: torch.Tensor) -> torch.Tensor:
        """A CPU tensor on the engine's device without waiting (pinned
        staging, as ``_to_device``)."""
        if self.device.type != "cuda":
            return host
        staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

    def _to_device(self, values, dtype: torch.dtype) -> torch.Tensor:
        """A host list or array as a tensor on the engine's device, without
        waiting: staged in pinned memory and copied with non_blocking=True
        (a copy from pageable memory waits for the stream). PyTorch's
        caching host allocator keeps the staging buffer until its copy has
        run. On the CPU, a plain copy."""
        host = torch.tensor(values, dtype=dtype)
        if self.device.type != "cuda":
            return host
        staged = torch.empty(host.shape, dtype=dtype, pin_memory=True)
        staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

    def _to_reader(self, kind: str, tensor: torch.Tensor, rows) -> None:
        """Start the copy of ``tensor`` to pinned host memory, record an
        event behind it and queue both for the reader (blocks while
        ``decode_runahead`` items wait). On the CPU the tensor itself."""
        host, event = self._start_host_copy(tensor)
        self._readback.put((kind, host, event, rows))

    def _start_host_copy(self, tensor: torch.Tensor):
        """Start ``tensor``'s copy into pinned host memory behind an event;
        on the CPU the tensor itself and no event."""
        if not tensor.is_cuda:
            return tensor, None
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _max_wave_rows(self, bucket: int) -> int:
        """Max prefill rows for this bucket under prefill_wave_tokens."""
        budget = self.engine_config.prefill_wave_tokens
        return max(1, min(self.num_slots, budget // max(1, bucket)))

    def _admit(self) -> None:
        """The dispatch loop's admission step, through the scheduler seam:
        ``unified`` claims and prefills a wave here, ``disagg`` imports
        the prefill tier's finished requests."""
        self.scheduler.admit()

    def _prefill_claimed(self, claimed: List[_Request], register: bool) -> list:
        """Fund a claimed wave's pages (``scheduler.claim_wave`` formed it)
        and prefill it: short prompts in one monolithic wave, long ones by
        chunks. Every dispatch of a wave is one bucket wide
        (``prefill_chunk``, or ``max_seq_len`` when that is shorter), so
        ``prefill_wave_tokens`` caps the wave at ``_max_wave_rows`` of it.
        ``register`` (unified: the slots are registered already) writes
        each row's state into the decode batch; otherwise (the disagg
        prefill tier) returns one ``KVHandoff`` a request for the decode
        tier's import."""
        chunk = self.engine_config.prefill_chunk
        if self._prefix is not None:
            # chunked prompts only (a shorter one has no cacheable chunk);
            # each hit pins its entry until its rows are secured: by the
            # retain in _fund (paged) or the fetch copy (fixed)
            for req in claimed:
                if len(req.prompt_ids) > chunk:
                    m = self._prefix.match(req.prompt_ids, hint=req.params.prefix_hint)
                    if m is not None:
                        req.prefix_entry, req.prefix_len = m
                        flight_recorder.event_rid(req.rid, "prefix_match",
                                                  cached_tokens=req.prefix_len)
        funded = self._fund(claimed)
        # the PP path prefills every prompt in one wave, as JAX's does
        chunked = self._pp is None
        short = [r for r in funded if not chunked or len(r.prompt_ids) <= chunk]
        long = [r for r in funded if chunked and len(r.prompt_ids) > chunk]
        records: list = []
        for wave, chunked in ((short, False), (long, True)):
            if wave:
                records += self._prefill_wave(wave, chunked, register)
        return records

    def _register(self, req: _Request, slot: int) -> None:
        """Give ``slot`` to ``req`` (caller holds self._lock): from here the
        loop's error handler owns it. Its budget counts the decode steps
        after the prefill's token, capped by the slot's capacity."""
        T = len(req.prompt_ids)
        req.slot = slot
        self._slot_req[slot] = req
        self._slot_budget[slot] = min(req.params.max_tokens - 1, self.max_seq_len - 1 - T)
        self._slot_pos[slot] = T

    def _fund(self, claimed: List[_Request]) -> List[_Request]:
        """Reserve every page each claimed request can touch, a prefix
        hit's shared pages first in its table, and write the funded rows'
        page tables to the device (JAX ``_fund_paged_admissions``). On a
        short pool the LRU unpinned prefix entry is evicted and the
        allocation retried; a request the pool still cannot fund goes
        back to the queue front with every later claim (OOM backpressure,
        FIFO order kept), their pins released. A fixed slot always holds
        ``max_seq_len`` rows: every claim is funded."""
        if not self._paged:
            return claimed
        page, chunk = self._page, self.engine_config.prefill_chunk
        funded: List[_Request] = []
        for idx, req in enumerate(claimed):
            ent = req.prefix_entry
            shared: List[int] = []
            if ent is not None:
                shared = list(ent.pages or ())[: req.prefix_len // page]
                if len(shared) * page < req.prefix_len:
                    # fewer pages than the matched depth: serve only the
                    # page-backed, chunk-aligned part
                    req.prefix_len = (len(shared) * page // chunk) * chunk
                    shared = shared[: req.prefix_len // page]
                # Retain first, then unpin: the refcount keeps the shared
                # pages alive from here, and a pin held through the
                # evict-and-retry loop below would keep this very entry
                # from being evicted to fund the request (a livelock on a
                # minimal pool).
                self._kv_alloc.retain(shared)
                self._prefix.release(ent)
                req.prefix_entry = None
            total = kv_pages.pages_needed(
                len(req.prompt_ids), req.params.max_tokens, page,
                self.max_seq_len, self._page_slack,
            )
            fresh_n = max(0, total - len(shared))
            fresh = self._kv_alloc.alloc(fresh_n, count_failure=False)
            while fresh is None and self._prefix is not None and self._prefix.evict_lru():
                fresh = self._kv_alloc.alloc(fresh_n, count_failure=False)
            if fresh is None:
                self._kv_alloc.record_alloc_failure()
                self._kv_alloc.release(shared)  # undo the map
                back = claimed[idx:]
                for r in back:
                    self._release(r.slot, r, tier=True)  # unpins a later claim's match
                    r.prefix_len = 0
                with self._lock:
                    self._pending.extendleft(reversed(back))
                    _M_QUEUE_DEPTH.set(len(self._pending))
                flight_recorder.event_rid(req.rid, "page_backpressure", pages_short=fresh_n)
                break
            self._kv_alloc.record_prefix_mapped(len(shared))
            if shared:
                flight_recorder.event_rid(req.rid, "prefix_pages_mapped", pages=len(shared),
                                          tokens=req.prefix_len)
            self._slot_pages[req.slot] = shared + fresh
            flight_recorder.event_rid(
                req.rid, "page_alloc", fresh=len(fresh), shared=len(shared),
                attn_path="kernel" if self._page_kernel else "gather",
            )
            funded.append(req)
        if funded:
            rows = np.zeros((len(funded), self._max_pages_per_slot), np.int32)
            for i, req in enumerate(funded):
                pages = self._slot_pages[req.slot]
                rows[i, : len(pages)] = pages
            slots = self._to_device([r.slot for r in funded], torch.long)
            self._tables[slots] = self._to_device(rows, torch.int32)
        return funded

    def _prefill_bucket(self, n: int) -> int:
        chunk = self.engine_config.prefill_chunk
        return min(-(-n // chunk) * chunk, self.max_seq_len)

    def _attention_window(self, needed: int) -> int:
        """Power-of-two attention window (>= 128) covering ``needed`` rows,
        for the gathered reads."""
        w = 128
        while w < needed and w < self.max_seq_len:
            w *= 2
        return min(w, self.max_seq_len)

    def _decode_window(self, max_pos: int) -> int:
        """The attention window of a decode block whose furthest slot is at
        ``max_pos``: full capacity when a kernel reads each slot's own
        length; otherwise the rung of ``max_pos + block``."""
        if self._page_kernel or self._kv_kernel:
            return self.max_seq_len
        return self._attention_window(max_pos + self._decode_block)

    def _prefill_wave(self, reqs: List[_Request], chunked: bool, register: bool = True) -> list:
        cfg = self.model_config
        N = len(reqs)
        lengths = np.array([len(r.prompt_ids) for r in reqs], np.int64)
        bucket = self._prefill_bucket(int(lengths.max()))
        tokens = np.zeros((N, bucket), np.int64)
        for i, req in enumerate(reqs):
            tokens[i, : lengths[i]] = req.prompt_ids
        slots = self._to_device([r.slot for r in reqs], torch.long)
        lengths_d = self._to_device(lengths, torch.long)
        _M_WAVES.inc()
        if chunked:
            cached = None
            if self._prefix is not None:
                cached = np.array([r.prefix_len for r in reqs], np.int64)
                if not self._paged:
                    self._fetch_prefixes(reqs)
            self._chunk_reqs = reqs
            try:
                last_h = self._prefill_chunked(tokens, lengths, slots, cached)
            finally:
                self._chunk_reqs = None
            logits = llama._head(
                self.params, last_h[:, None, :], cfg, self._quant_kernel, self._tp
            )[:, 0, :]
        else:
            for req in reqs:
                flight_recorder.event_rid(req.rid, "prefill_wave", bucket=bucket, wave_rows=N,
                                          live_rows=N)
            self._telemetry.record_dispatch("prefill", tokens=int(lengths.sum()), rows=N)
            t_wall, t0 = time.time(), time.perf_counter()
            with self._annotate("engine.prefill_wave"):
                tokens_d = self._to_device(tokens, torch.long)
                if self._pp is not None:
                    logits, _ = self._pp_prefill(self.params, self._cache, tokens_d, lengths_d, slots)
                else:
                    logits, kvs = llama.prefill_layers(
                        self.params, cfg, tokens_d, lengths_d, quant_kernel=self._quant_kernel,
                        tp=self._tp,
                    )
                    if self._paged:
                        llama.write_prefill_pages(self._cache, kvs, self._tables[slots],
                                                  self._page, tp=self._tp)
                    else:
                        llama.write_prefill_slots(self._cache, kvs, slots, tp=self._tp)
                    del kvs
            if self._dtl is not None:
                self._dtl.record_span(
                    "prefill", t_wall=t_wall, lock_wait_s=0.0, run_s=time.perf_counter() - t0,
                    rows=N, tokens=int(lengths.sum()), rids=[r.rid for r in reqs],
                )
        temps = self._to_device([r.params.temperature for r in reqs], torch.float32)
        topps = self._to_device([r.params.top_p for r in reqs], torch.float32)
        seeds = self._to_device([r.sampling_seed & 0x7FFFFFFF for r in reqs], torch.long)
        keys = None
        if any(r.params.temperature > 0 for r in reqs):
            keys = sampling.sample_keys(seeds, lengths_d)  # the first token is keyed at T
        first = sampling.sample_tokens(logits[:, : self._sample_vocab], temps, topps, keys)
        prop = self._spec_proposer
        eligible = np.array([
            self._spec_enabled and prop is not None and prop.eligible(r.params) for r in reqs
        ])
        first_np = None
        if eligible.any():
            # the next proposal needs these first tokens on the host (a
            # wave with no drafting row keeps the pipelined readback)
            with spec_decode_mod.allowed_sync("spec"):
                first_np = first.cpu().numpy()
        spec_tokens = [
            list(r.prompt_ids) + [int(first_np[i])] if eligible[i] else None
            for i, r in enumerate(reqs)
        ]
        records = []
        if register:
            self._update_slots(slots, first, lengths_d, temps, topps, seeds)
            with self._lock:
                for req, ctx in zip(reqs, spec_tokens):
                    if ctx is not None:
                        self._spec_ctx[req.slot] = ctx
                    flight_recorder.event_rid(req.rid, "decode_join", slot=req.slot,
                                              position=len(req.prompt_ids))
                self._update_occupancy_gauges()
        else:
            # the decode tier writes each row's state at its import
            per_page = self._page_bytes()
            for i, req in enumerate(reqs):
                T = int(lengths[i])
                pages = tuple(self._slot_pages.get(req.slot, ()))
                records.append(handoff_mod.KVHandoff(
                    req=req, slot=req.slot, position=T,
                    budget=min(req.params.max_tokens - 1, self.max_seq_len - 1 - T),
                    pages=pages, nbytes=len(pages) * per_page,
                    state=tuple(t[i:i + 1] for t in (slots, first, lengths_d, temps, topps, seeds)),
                    spec_tokens=spec_tokens[i],
                ))
        if first_np is not None and self._draft is not None and prop.uses_draft_model:
            # the wave's prompts into the draft cache, then each drafting
            # slot's frontier at its prompt length: the first round's
            # catch-up feeds just the first token
            slot_list = [r.slot for r in reqs]
            self._draft.prefill_wave(tokens, lengths, slot_list, eligible)
            for i, req in enumerate(reqs):
                if eligible[i]:
                    prop.on_admit(req.slot, int(lengths[i]))
                    flight_recorder.event_rid(req.rid, "draft_prefill",
                                              prompt_tokens=int(lengths[i]),
                                              spec_proposer=prop.kind)
        self._counters["prefill_waves"] += 1
        self._counters["prefill_tokens"] += int(lengths.sum())
        self._counters["requests_prefilled"] += len(reqs)
        for req, n in zip(reqs, lengths):
            req.position = int(n)
        self._to_reader("prefill", first, list(enumerate(reqs)))
        if chunked and self._prefix is not None:
            self._insert_prefixes(reqs)
        return records

    def _page_bytes(self) -> int:
        """Device bytes one pool page holds across every layer (scale
        planes included)."""
        return sum(t[0].numel() * t.element_size() for t in _cache_tensors(self._cache))

    def _import_handoff(self, rec) -> None:
        """The decode tier's import of a prefill-tier record (dispatch
        thread): the KV is in the pool pages already, so the import
        writes the row's slot state and registers the request. A request
        that finished meanwhile (its first token was its last, or it was
        aborted and emitted) gives its slot and pages back here, since no
        release path owns a tier-held slot; one whose pages went dead is
        requeued for a full prefill and counted (it must not happen)."""
        req = rec.req
        with self._lock:
            if self._tier_slots.get(rec.slot) is not req:
                return  # released already (shutdown)
            if req.finished:
                self._release(rec.slot, req, tier=True)
                return
            if rec.pages and not all(self._kv_alloc.refcount(p) > 0 for p in rec.pages):
                handoff_mod.record_recompute()
                logger.error("handoff import found dead pages for rid %d; requeueing for "
                             "a full prefill", req.rid)
                # give back the part of the reservation still live
                self._slot_pages[rec.slot] = [p for p in rec.pages
                                              if self._kv_alloc.refcount(p) > 0]
                self._release(rec.slot, req, tier=True)
                req.prefix_len = 0
                self._pending.appendleft(req)
                self._lock.notify_all()
                return
            del self._tier_slots[rec.slot]
            flight_recorder.event_rid(req.rid, "tier_assign", tier="decode", slot=rec.slot)
            if rec.spec_tokens is not None:
                self._spec_ctx[rec.slot] = list(rec.spec_tokens)
            self._slot_req[rec.slot] = req
            flight_recorder.event_rid(req.rid, "decode_join", slot=rec.slot,
                                      position=rec.position)
            self._slot_budget[rec.slot] = rec.budget
            self._slot_pos[rec.slot] = rec.position
            self._update_occupancy_gauges()
        self._update_slots(*rec.state)

    def _fail_claims(self, reqs: List[_Request], exc: BaseException) -> None:
        """A prefill-tier wave failed: its requests end with the error and
        their claims go back."""
        for req in reqs:
            if not req.finished:
                req.error = exc
                self._finish(req)
            with self._lock:
                slot = req.slot
            if slot >= 0:
                self._release(slot, req, tier=True)

    def _fetch_prefixes(self, reqs: List[_Request]) -> None:
        """Fixed layout: copy each hit's cached rows from the prefix store
        into its slot before the first chunk reads them, then unpin the
        entry: any later write of the store slot (an insert after an
        eviction) is ordered behind this copy on the stream."""
        for req in reqs:
            ent = req.prefix_entry
            if ent is None:
                continue
            with self._annotate("engine.prefix_fetch"):
                llama.copy_kv_rows(self._prefix_store, self._cache, ent.store_slot, req.slot,
                                   req.prefix_len)
            self._counters["prefix_copy_dispatches"] += 1
            _M_PREFIX_COPY.inc()
            self._prefix.release(ent)
            req.prefix_entry = None

    def _insert_prefixes(self, reqs: List[_Request]) -> None:
        """Index each prefilled prompt's chunk-aligned prefix (JAX's insert
        after the wave). Paged: the entry takes a reference on the
        request's own pages over the span, whose rows no later write
        touches (decode writes positions >= the prompt length, past the
        span, and a skipped chunk writes the scratch page). Fixed: one
        copy of the rows into the entry's store slot, ordered behind the
        chunks that wrote them."""
        for req in reqs:
            if self._paged:
                ent = self._prefix.insert_entry(req.prompt_ids, hint=req.params.prefix_hint)
                if ent is None:
                    continue
                donated = list(self._slot_pages.get(req.slot, ()))[: ent.length // self._page]
                self._kv_alloc.retain(donated)
                ent.pages = donated
                continue
            ins = self._prefix.insert(req.prompt_ids, hint=req.params.prefix_hint)
            if ins is None:
                continue
            store_slot, length = ins
            with self._annotate("engine.prefix_insert"):
                llama.copy_kv_rows(self._cache, self._prefix_store, req.slot, store_slot, length)
            self._counters["prefix_copy_dispatches"] += 1
            _M_PREFIX_COPY.inc()

    def _update_slots(self, slots, tokens, positions, temps, topps, seeds) -> None:
        """Admission: the wave's state into the device-resident slot
        tensors, one indexed write each, ordered on the stream behind the
        blocks already dispatched. ``tokens`` are the prefill's sampled
        first tokens, never read back for this."""
        self._tokens_dev[slots] = tokens
        self._positions_dev[slots] = positions
        self._temps_dev[slots] = temps
        self._topps_dev[slots] = topps
        self._seeds_dev[slots] = seeds
        self._live_dev.index_fill_(0, slots, True)

    def _prefill_chunked(self, tokens: np.ndarray, lengths: np.ndarray, slots: torch.Tensor,
                         cached: Optional[np.ndarray] = None):
        """Chunk k extends every row by up to prefill_chunk tokens at offset
        k * C (rows whose prompt ended earlier run with valid = 0 and write
        only the scratch page, or write back what they read on the fixed
        layout); returns each row's last-token hidden. ``cached`` (chunk
        aligned, < each row's length) holds each row's rows already in
        place from the prefix cache: the loop starts at the wave's least
        cached chunk, and a row runs with valid = 0 in every chunk below
        its own. The wave's requests (``_chunk_reqs``, row-aligned, set by
        ``_prefill_wave``) get one ``prefill_chunk`` flight event per chunk
        that extends them."""
        reqs = self._chunk_reqs
        dev = self.device
        C = self.engine_config.prefill_chunk
        N, Tmax = tokens.shape
        k0 = int(cached.min()) // C if cached is not None and len(cached) else 0
        last_h = torch.zeros(
            (N, self.model_config.hidden_size), dtype=self.params["embed"].dtype, device=dev
        )
        for k in range(k0, -(-Tmax // C)):
            tok_k = np.zeros((N, C), np.int64)
            seg = tokens[:, k * C:(k + 1) * C]
            tok_k[:, : seg.shape[1]] = seg
            valid_np = np.clip(lengths - k * C, 0, C)
            if cached is not None:
                valid_np = np.where(k * C < cached, 0, valid_np)
            valid = self._to_device(valid_np, torch.long)
            offsets = torch.full((N,), k * C, dtype=torch.long, device=dev)
            window = self._attention_window(min((k + 1) * C, self.max_seq_len))
            tok_d = self._to_device(tok_k, torch.long)
            t_wall, t0 = time.time(), time.perf_counter()
            with self._annotate("engine.prefill_chunk"):
                if self._paged:
                    cand, _ = llama.extend_layers_paged(
                        self.params, self.model_config, tok_d, offsets, valid, slots,
                        self._tables, self._cache, window, self._page,
                        quant_kernel=self._quant_kernel, tp=self._tp,
                    )
                else:
                    cand, _ = llama.extend_layers(
                        self.params, self.model_config, tok_d, offsets, valid, slots,
                        self._cache, window, quant_kernel=self._quant_kernel, tp=self._tp,
                    )
                last_h = torch.where((valid > 0)[:, None], cand, last_h)
            live_rows, live_tokens = int((valid_np > 0).sum()), int(valid_np.sum())
            if self._dtl is not None:
                self._dtl.record_span(
                    "prefill_chunk", t_wall=t_wall, lock_wait_s=0.0,
                    run_s=time.perf_counter() - t0, rows=live_rows, tokens=live_tokens,
                    rids=[r.rid for r in reqs] if reqs is not None else (),
                )
            self._telemetry.record_dispatch(
                "prefill", tokens=live_tokens,
                cache_bytes=hardware.kv_read_bytes_per_step(
                    self.model_config, N, window, self._kv_byte_width),
                rows=live_rows,
            )
            if reqs is not None and flight_recorder.enabled():
                for i, req in enumerate(reqs):
                    if valid_np[i] > 0:
                        flight_recorder.event_rid(req.rid, "prefill_chunk", chunk=k,
                                                  window=window, tokens=int(valid_np[i]))
            self._counters["prefill_chunks"] += 1
            _M_PREFILL_CHUNKS.inc()
        return last_h

    def _decode_once(self) -> None:
        """One decode dispatch. A pipelined verify still in flight lands
        first (shadows, contexts and budgets must be current, even if spec
        was turned off meanwhile); then, while any live row can draft, one
        spec round (``_spec_decode_once``), otherwise one block of
        ``decode_block`` steps over every slot, from and into the
        device-resident slot state. Budget-exhausted, finished and
        cancelled slots are freed first, so pending requests take them
        instead of dead steps; the reader still emits the final tokens of
        budget-exhausted requests from the slabs already dispatched (the
        snapshot pins rows to their requests).

        A slot is dispatched only while its budget is positive, so a block
        writes at most ``decode_block - 1`` positions past its last token
        and a verify at most its capped draft: the ``decode_block + K +
        1`` pages of slack funded at admission (``_page_slack``) bound
        both, whatever the runahead."""
        if self._spec_pending is not None:
            self._flush_spec_pipeline()
        if self._spec_enabled and self._spec_has_draftable():
            self._spec_decode_once()
            return
        # runahead drafts only feed a spec round
        self._spec_reconcile = None
        block = self._decode_block
        with self._lock:
            self._release_finished_slots()
            if not self._slot_req:
                return
            snapshot = sorted(self._slot_req.items())
            window = self._decode_window(max(self._slot_pos.values()))
            read_bytes = self._decode_read_bytes(window)
            for slot in self._slot_pos:
                self._slot_pos[slot] += block
                self._slot_budget[slot] -= block
            self._update_occupancy_gauges()
        t_dispatch = time.perf_counter()
        token_slab = self._dispatch_block(window, snapshot, "decode", read_bytes)
        self._counters["decode_dispatches"] += 1
        self._to_reader("decode", token_slab, (snapshot, t_dispatch))

    def _decode_read_bytes(self, window: int) -> int:
        """KV bytes one decode step reads (caller holds the lock): the
        live rows, page-rounded, where a kernel reads each row's own
        length; else the window for every row."""
        if self._page_kernel or self._kv_kernel:
            page = self._page if self._paged else 1
            tokens = sum(min(kv_pages.pages_for_tokens(min(p, self.max_seq_len), page) * page,
                             self.max_seq_len) for p in self._slot_pos.values())
            return hardware.kv_read_bytes_ragged(self.model_config, tokens, self._kv_byte_width)
        return hardware.kv_read_bytes_per_step(
            self.model_config, self.num_slots, window, self._kv_byte_width)

    def _dispatch_block(self, window: int, snapshot, kind: str = "decode",
                        read_bytes: int = 0) -> torch.Tensor:
        """Launch one block of ``decode_block`` steps over every slot;
        returns the token slab ``[block, B]`` (a tensor of its own:
        admission rewrites ``_tokens_dev`` in place while the slab may
        still be on its way to the host). The dispatch is counted, timed
        on the host and labelled as ``kind`` (``decode`` or
        ``spec_block``)."""
        t_wall, t0 = time.time(), time.perf_counter()
        with self._annotate("engine.decode_block"):
            slab = self._launch_block(window, snapshot)
        block = self._decode_block
        rows = len(snapshot)
        path = None
        if self._paged:
            path = "kernel" if self._page_kernel else "gather"
            _M_PAGED_ATTN.labels(path=path).inc()
        _M_DECODE_STEPS.inc(block)
        _M_DECODE_DISPATCHES.inc()
        if self._dtl is not None:
            self._dtl.record_span(kind, t_wall=t_wall, lock_wait_s=0.0,
                                  run_s=time.perf_counter() - t0, rows=rows, tokens=block * rows,
                                  steps=block, path=path, rids=[r.rid for _, r in snapshot])
        self._telemetry.record_dispatch(kind, tokens=block * rows, weight_passes=block,
                                        cache_bytes=block * read_bytes, steps=block, rows=rows,
                                        path=path)
        return slab

    def _launch_block(self, window: int, snapshot) -> torch.Tensor:
        """The block's launches, from and into the device slot state."""
        block = self._decode_block
        max_pos = self.max_seq_len - 1
        tok = self._tokens_dev
        pos = torch.where(self._live_dev, self._positions_dev, 0)
        keys = None
        if any(req.params.temperature > 0 for _, req in snapshot):
            # the token produced from input position p is keyed at p + 1;
            # the whole block's keys [block, B] in one device computation
            steps = torch.arange(block, device=self.device)[:, None]
            step_pos = torch.clamp(pos[None, :] + steps, max=max_pos)
            keys = sampling.sample_keys(self._seeds_dev, torch.clamp(step_pos + 1, max=max_pos))
        token_slab = []
        for s in range(block):
            if self._paged:
                logits, _ = llama.decode_layers_paged(
                    self.params, self.model_config, tok, pos, self._live_dev, self._tables,
                    self._cache, window=window, page_size=self._page,
                    quant_kernel=self._quant_kernel, page_kernel=self._page_kernel, tp=self._tp,
                )
            elif self._pp is not None:
                logits, _ = self._pp_decode(self.params, self._cache, tok, pos, window)
            else:
                logits, _ = llama.decode_layers(
                    self.params, self.model_config, tok, pos, self._cache,
                    window=window, quant_kernel=self._quant_kernel, kv_kernel=self._kv_kernel,
                    tp=self._tp,
                )
            tok = sampling.sample_tokens(
                logits[:, : self._sample_vocab], self._temps_dev, self._topps_dev,
                None if keys is None else (keys[0][s], keys[1][s]),
            )
            token_slab.append(tok)
            pos = torch.clamp(pos + 1, max=max_pos)
        self._tokens_dev.copy_(tok)
        self._positions_dev.copy_(pos)
        return torch.stack(token_slab)

    # ------------------------------------------------------------------ #
    # speculative decoding (dispatch thread)

    def _spec_has_draftable(self) -> bool:
        """Whether any live row could draft: proposer-eligible and holding
        a context (rows admitted while spec was off never draft). When
        none can, the pipelined block path serves the batch."""
        prop = self._spec_proposer
        if prop is None:
            return False
        with self._lock:
            return any(slot in self._spec_ctx and prop.eligible(req.params)
                       for slot, req in self._slot_req.items())

    def _spec_stage_arrays(self, K: int):
        """This round's host draft inputs, zeroed: ``[B, K]`` draft tokens
        and ``[B]`` lengths. Fresh arrays a round: ``_to_device`` copies
        them at once, and a pipelined round keeps its lengths for the
        flush."""
        return (np.zeros((self.num_slots, K), np.int64),
                np.zeros((self.num_slots,), np.int64))

    def _spec_decode_once(self) -> None:
        """One speculative verify dispatch.

        The proposer drafts up to K tokens for each live eligible slot
        (capped by ``cap_draft_len``); one verify (``spec_verify`` or
        ``spec_verify_paged``) scores every draft position of the whole
        batch, advances each row's device token and position past its
        accepted prefix plus the bonus token, and returns one packed ``[B,
        K+2]`` tensor (the K+1 output tokens, then the accepted count).

        Synchronous (``spec_pipeline_enable='off'``, or a proposer that
        cannot run ahead): the dispatch thread reads the packed result
        back here, its one allowed sync, since the next proposal needs
        this round's tokens. Pipelined: the verify is left in flight with
        its host copy started, the next round's drafts are proposed from
        the optimistic context (everything drafted accepted) meanwhile,
        and the result lands at the start of the next dispatch
        (``_flush_spec_pipeline``), which confirms or rolls back those
        drafts. Drafts only steer acceptance, never emission: streams are
        token-identical across pipeline on/off and spec on/off."""
        reconcile = self._spec_reconcile
        self._spec_reconcile = None
        K = self._spec_draft
        if self._adaptive_k is not None:
            K = self._adaptive_k.pick(self.scheduler.tracker.ratio())
        with self._lock:
            self._release_finished_slots()
            if not self._slot_req:
                return
            max_pos_live = max(self._slot_pos.values(), default=0)
            # the chunk writes K + 1 rows past each live position; the page
            # kernel reads each row's own length
            if self._verify_kernel:
                window = self.max_seq_len
            else:
                window = self._attention_window(min(max_pos_live + K + 1, self.max_seq_len))
            snapshot = sorted(self._slot_req.items())
            caps = {slot: spec_decode_mod.cap_draft_len(
                K, self._slot_pos[slot], self._slot_budget[slot], self.max_seq_len)
                for slot, _ in snapshot}
        prop = self._spec_proposer
        # draft-aware scheduling: a collapsed acceptance skips the draft
        # model's dispatch (lookup scans cost nothing and never skip)
        if prop.uses_draft_model and not self.scheduler.should_draft():
            self._spec_block_fallback(snapshot, max_pos_live)
            return
        pipelined = self._spec_pipeline and prop.supports_runahead
        draft, draft_len = self._spec_stage_arrays(K)
        prop_rows = []
        for slot, req in snapshot:
            ctx = self._spec_ctx.get(slot)
            if ctx and prop.eligible(req.params):
                prop_rows.append((slot, ctx, caps[slot]))
        proposals = self._spec_propose(prop, prop_rows, reconcile)
        for slot, d in proposals.items():
            if d:
                draft[slot, : len(d)] = d
                draft_len[slot] = len(d)
        if not draft_len.any():
            # no row drafted: a one-token verify would forfeit the block's
            # fusion for nothing
            self._spec_block_fallback(snapshot, max_pos_live)
            return
        if self._adaptive_k is not None:
            spec_decode_mod.record_adaptive_round(K)
        t_dispatch = time.perf_counter()
        args = (
            self.params, self.model_config, self._cache, self._tokens_dev, self._positions_dev,
            self._temps_dev, self._topps_dev, self._seeds_dev,
            self._to_device(draft, torch.long), self._to_device(draft_len, torch.long),
            self._live_dev, window,
        )
        opts = dict(max_pos=self.max_seq_len - 1, vocab=self._sample_vocab,
                    sampled=any(req.params.temperature > 0 for _, req in snapshot),
                    quant_kernel=self._quant_kernel, tp=self._tp)
        t_wall, t0 = time.time(), time.perf_counter()
        with self._annotate("engine.spec_verify"):
            if self._paged:
                new_tokens, new_positions, packed = spec_verify_paged(
                    *args, self._tables, self._page, page_kernel=self._verify_kernel, **opts)
            else:
                new_tokens, new_positions, packed = spec_verify(*args, **opts)
            self._tokens_dev.copy_(new_tokens)
            self._positions_dev.copy_(new_positions)
        path = None
        if self._paged:
            path = "kernel" if self._verify_kernel else "gather"
            _M_PAGED_ATTN.labels(path=path).inc()
        _M_DECODE_STEPS.inc(1)
        _M_DECODE_DISPATCHES.inc()
        if self._dtl is not None:
            self._dtl.record_span("spec", t_wall=t_wall, lock_wait_s=0.0,
                                  run_s=time.perf_counter() - t0, rows=len(snapshot),
                                  tokens=int(draft_len.sum()) + len(snapshot), path=path,
                                  rids=[r.rid for _, r in snapshot])
        with self._lock:
            # the state the verify ran at (the shadows move at its landing)
            spec_bytes = self._decode_read_bytes(window)
        self._counters["decode_dispatches"] += 1
        self._counters["spec_verify_dispatches"] += 1
        if pipelined:
            host, event = self._start_host_copy(packed)
            self._spec_pending = {
                "host": host, "event": event, "snapshot": snapshot, "draft_len": draft_len,
                "t_dispatch": t_dispatch, "path": path, "spec_bytes": spec_bytes,
                "opt": self._spec_runahead_proposals(prop, prop_rows, proposals, K),
            }
            return
        t_rb = time.time()
        with spec_decode_mod.allowed_sync("spec"):
            packed_np = packed.cpu().numpy()
        self._observe_readback("spec", time.time() - t_rb)
        self._spec_apply_readback(packed_np, snapshot, draft_len, t_dispatch, path, spec_bytes)

    def _flush_spec_pipeline(self) -> None:
        """Land the verify in flight: wait for its packed result (the copy
        was started at dispatch, so this waits only for what the host work
        since did not cover), apply it one round late, and reconcile the
        runahead drafts against the real acceptance, leaving (confirmed,
        missed) for the next spec round. Runs at the top of every
        dispatch, at the drain's park and at shutdown. The fault point
        ``engine.spec_pipeline`` (``error``) invalidates every runahead
        draft of the flush."""
        pending = self._spec_pending
        self._spec_pending = None
        self._spec_reconcile = None
        if pending is None:
            return
        t_rb = time.time()
        with spec_decode_mod.allowed_sync("spec"):
            if pending["event"] is not None:
                pending["event"].synchronize()
            packed_np = pending["host"].numpy()
        wait_s = time.time() - t_rb
        _M_READBACK.labels(kind="spec").observe(wait_s, trace_id=None)
        self._telemetry.record_readback("spec", wait_s)
        if self._dtl is not None:
            self._dtl.record_pipeline_flush(wait_s, rows=len(pending["snapshot"]))
        self._spec_apply_readback(packed_np, pending["snapshot"], pending["draft_len"],
                                  pending["t_dispatch"], pending["path"], pending["spec_bytes"])
        opt = pending["opt"]
        if not opt:
            return
        out_np, acc_np = packed_np[:, :-1], packed_np[:, -1]
        forced = False
        try:
            faults_mod.fault_point("engine.spec_pipeline")
        except faults_mod.FaultInjected:
            forced = True  # every runahead draft of this flush is a miss
        confirmed: Dict[int, List[int]] = {}
        missed = set()
        for slot, (dlen, od) in opt.items():
            acc = int(acc_np[slot])
            # the runahead assumed full acceptance, and its first token
            # predicted the bonus token
            if not forced and acc == dlen and od and od[0] == int(out_np[slot, acc]):
                if len(od) > 1:
                    confirmed[slot] = od[1:]
                else:
                    # spent predicting the bonus token: validated, nothing
                    # left to dispatch
                    self._counters["spec_pipeline_confirmed"] += 1
                    _M_SPEC_PIPE_CONFIRMED.inc()
            else:
                missed.add(slot)
        self._spec_reconcile = (confirmed, missed)

    def _spec_apply_readback(self, packed_np: np.ndarray, snapshot, draft_len,
                             t_dispatch: float, path: Optional[str] = None,
                             spec_bytes: int = 0) -> None:
        """Apply a landed verify (the synchronous path right after its
        read, the pipeline's flush one round later): the scheduler's
        acceptance window, the counters, each row's budget and position
        shadows and proposer context, then the reader's emission. A row
        released (or recycled) while its verify was in flight is
        skipped."""
        t_done = time.perf_counter()
        out_np, acc_np = packed_np[:, :-1], packed_np[:, -1]
        self._telemetry.record_dispatch(
            "spec", tokens=sum(int(acc_np[s]) + 1 for s, _ in snapshot),
            cache_bytes=spec_bytes, rows=len(snapshot), path=path,
        )
        self.scheduler.record_spec_round(
            int(draft_len.sum()), sum(int(acc_np[s]) for s, _ in snapshot))
        prop_kind = self._spec_proposer.kind if self._spec_proposer is not None else None
        with self._lock:
            for slot, req in snapshot:
                n = int(acc_np[slot]) + 1
                spec_decode_mod.record_dispatch(int(draft_len[slot]), n - 1)
                if self._slot_req.get(slot) is not req:
                    continue
                if int(draft_len[slot]):
                    flight_recorder.event_rid(req.rid, "spec_verify",
                                              drafted=int(draft_len[slot]), accepted=n - 1,
                                              spec_proposer=prop_kind)
                self._slot_budget[slot] -= n
                self._slot_pos[slot] = min(self._slot_pos[slot] + n, self.max_seq_len - 1)
                buf = self._spec_ctx.get(slot)
                if buf is not None:
                    buf.extend(int(t) for t in out_np[slot, :n])
        # put() outside the lock: the reader needs it in _emit
        self._readback.put(("spec", (out_np, acc_np), None, (snapshot, t_dispatch, t_done)))

    def _spec_propose(self, prop, prop_rows, reconcile) -> Dict[int, List[int]]:
        """This round's drafts: confirmed runahead drafts as they are
        (clipped to this round's caps), a fresh proposal from the true
        context for every other row (rolled-back rows counted)."""
        if reconcile is None:
            return prop.propose_wave(prop_rows) if prop_rows else {}
        confirmed, missed = reconcile
        proposals: Dict[int, List[int]] = {}
        fresh = []
        rolled = 0
        for slot, ctx, cap in prop_rows:
            d = confirmed.get(slot)
            if d is not None:
                d = d[:cap]
                if d:
                    proposals[slot] = d
                    self._counters["spec_pipeline_confirmed"] += 1
                    _M_SPEC_PIPE_CONFIRMED.inc()
                    continue
            if slot in missed:
                rolled += 1
            fresh.append((slot, ctx, cap))
        t0 = time.time()
        if fresh:
            proposals.update(prop.propose_wave(fresh))
        self._counters["spec_pipeline_rollbacks"] += rolled
        if rolled:
            _M_SPEC_PIPE_ROLLBACKS.inc(rolled)
            if self._dtl is not None:
                self._dtl.record_rollback(time.time() - t0, rows=rolled)
        return proposals

    def _spec_runahead_proposals(self, prop, prop_rows, proposals, K):
        """Draft round N+1 while verify N runs, assuming its whole draft is
        accepted: the optimistic context is the true one plus the draft (a
        new list; the contexts are not touched), the optimistic cap
        assumes the bonus token landed too, and the first optimistic token
        is the prediction of that bonus token, so the flush confirms with
        one comparison. ``{slot: (draft length, optimistic draft)}``."""
        with self._lock:
            pos = dict(self._slot_pos)
            budget = dict(self._slot_budget)
        opt_rows = []
        opt_dlen = {}
        for slot, ctx, _cap in prop_rows:
            d = proposals.get(slot) or []
            dlen = len(d)
            opt_cap = spec_decode_mod.cap_draft_len(
                K, min(pos.get(slot, 0) + dlen + 1, self.max_seq_len - 1),
                budget.get(slot, 0) - (dlen + 1), self.max_seq_len,
            )
            if opt_cap < 1:
                continue  # the row ends (or nearly) this round
            opt_rows.append((slot, list(ctx) + d, opt_cap))
            opt_dlen[slot] = dlen
        if not opt_rows:
            return {}
        od = prop.propose_wave(opt_rows)
        return {slot: (opt_dlen[slot], od.get(slot) or []) for slot in opt_dlen}

    def _spec_block_fallback(self, snapshot, max_pos_live: int) -> None:
        """One block of ``decode_block`` steps from inside spec mode, when
        no live row drafted (or the draft model was skipped): the plain
        block, but its slab is read back here (an allowed spec sync) so
        the contexts and shadows stay exact for the next round's
        proposals; the reader gets the host slab."""
        block = self._decode_block
        window = self._decode_window(max_pos_live)
        with self._lock:
            read_bytes = self._decode_read_bytes(window)
        t_dispatch = time.perf_counter()
        slab = self._dispatch_block(window, snapshot, "spec_block", read_bytes)
        self._counters["decode_dispatches"] += 1
        self._counters["spec_block_dispatches"] += 1
        t_rb = time.time()
        with spec_decode_mod.allowed_sync("spec"):
            slab_np = slab.cpu().numpy()  # [block, B]
        self._observe_readback("spec_block", time.time() - t_rb)
        t_done = time.perf_counter()
        with self._lock:
            for slot, req in snapshot:
                if self._slot_req.get(slot) is not req:
                    continue
                self._slot_budget[slot] -= block
                self._slot_pos[slot] += block
                buf = self._spec_ctx.get(slot)
                if buf is not None:
                    buf.extend(int(t) for t in slab_np[:, slot])
        self._readback.put(("spec_block", slab_np, None, (snapshot, t_dispatch, t_done)))

    def _release_finished_slots(self) -> None:
        """Free budget-exhausted, finished and cancelled slots before a
        dispatch (caller holds self._lock). A cancelled request gets its
        end here: once the slot is recycled no readback finishes it."""
        for slot, req in list(self._slot_req.items()):
            if req.cancelled or req.finished or self._slot_budget[slot] <= 0:
                if req.cancelled:
                    self._finish(req)
                self._release(slot, req)

    def _release(self, slot: int, req: _Request, tier: bool = False) -> None:
        """Free ``slot`` while it still belongs to ``req`` (a late release
        of an earlier owner is a no-op), its prefix pin if it still holds
        one and, on the paged layout, its pages; its table row points back
        at the scratch page. ``tier`` also frees a slot the disagg prefill
        tier holds (the claim's owner releases it; the reader's releases
        do not). Dispatch thread, the prefill tier for its own claims, the
        drain thread while the loop is parked, or shutdown. Blocks already
        dispatched for the slot run before anything a new owner enqueues,
        so its pages and strip are reusable at once; the slot's device
        resets are launched before it is free to claim again."""
        with self._lock:
            if self._slot_req.get(slot) is req:
                owner = self._slot_req
            elif tier and self._tier_slots.get(slot) is req:
                owner = self._tier_slots
            else:
                return
            # the pin, the pages and the device resets go first: a request
            # gone from _slot_req holds none of them (the allocator's and
            # the index's locks are leaves, taken under this one)
            if req.prefix_entry is not None:
                # a match whose rows were never secured (requeue, a failed wave)
                self._prefix.release(req.prefix_entry)
                req.prefix_entry = None
            pages = self._slot_pages.pop(slot, None)
            if pages:
                # shared prefix pages keep the entry's reference
                freed = self._kv_alloc.release(pages)
                self._kv_alloc.observe_request_pages(len(pages))
                if req.flight_rec is not None:
                    # on the record itself: the rid unmapped when the
                    # stream finished, the free happens now
                    req.flight_rec.event("page_free", rid=req.rid, pages=len(pages),
                                         freed=freed)
            if self._paged:
                self._tables[slot].fill_(0)
            self._live_dev[slot].fill_(False)
            self._positions_dev[slot].fill_(0)
            del owner[slot]
            self._slot_budget.pop(slot, None)
            self._slot_pos.pop(slot, None)
            self._spec_ctx.pop(slot, None)
            if self._spec_proposer is not None:
                # the draft frontier dies with the slot (a recycled slot's
                # draft strip is prefilled again from position 0)
                self._spec_proposer.on_release(slot)
            req.slot = -1
            self._free_slots.append(slot)
            if owner is self._slot_req:
                flight_recorder.event_rid(req.rid, "decode_leave", slot=slot,
                                          generated=req.generated)
            self._update_occupancy_gauges()
            self._lock.notify_all()  # wakes ingest_window when the last slot frees

    def _update_occupancy_gauges(self) -> None:
        """Slot occupancy and KV utilization gauges (caller holds the
        lock; host arithmetic only). Paged: live rows over the pool, and
        the reserved-but-unwritten share of live requests' pages."""
        _M_SLOTS_IN_USE.set(len(self._slot_req))
        used = sum(min(p, self.max_seq_len) for p in self._slot_pos.values())
        if self._paged:
            cap = self._kv_alloc.capacity * self._page
            _M_KV_UTILIZATION.set(used / cap if cap else 0.0)
            held = self._page * sum(len(p) for p in self._slot_pages.values())
            self._kv_alloc.set_fragmentation(1.0 - used / held if held else 0.0)
            return
        cap = self.num_slots * self.max_seq_len
        _M_KV_UTILIZATION.set(used / cap if cap else 0.0)

    # ------------------------------------------------------------------ #
    # reader thread: the one place that waits for the device

    def _reader_loop(self) -> None:
        while True:
            item = self._readback.get()
            if item is None:  # shutdown: every earlier item was emitted
                with self._lock:
                    live = list(self._slot_req.values())
                for req in live:
                    self._finish(req, "shutdown")
                return
            kind, host, event, rows = item
            if kind == "drain_barrier":
                # enqueued last by a drain after the park: every earlier
                # readback is emitted, positions and transcripts are current
                host.set()
                continue
            if kind in ("spec", "spec_block"):
                # read back by the dispatch thread already (its proposals
                # needed them): emit each row's accepted tokens and bonus
                # token, or the block's slab, as a decode slab
                self._emit_spec(kind, host, rows)
                continue
            try:
                t0 = time.time()
                if event is not None:
                    event.synchronize()  # releases the GIL while it waits
                values = host.numpy()
                self._observe_readback(kind, time.time() - t0)
            except Exception as exc:  # noqa: BLE001 - fail this item's requests, keep reading
                logger.exception("LLM engine readback error: %s", exc)
                for _, req in rows if kind == "prefill" else rows[0]:
                    if not req.finished:
                        req.error = exc
                        self._finish(req)
                continue
            done = time.perf_counter()
            counters = self._reader_counters
            counters["readbacks"] += 1
            if kind == "prefill":
                for row, req in rows:
                    if not req.finished:
                        self._emit(req, int(values[row]))
            else:
                snapshot, t_dispatch = rows
                counters["decode_blocks"] += 1
                counters["decode_steps"] += len(values)
                counters["decode_rows"] += len(values) * len(snapshot)
                counters["decode_row_dispatches"] += len(snapshot)
                counters["decode_time_s"] += done - max(t_dispatch, self._last_readback)
                for row in values:
                    for slot, req in snapshot:
                        if req.finished:
                            continue  # overran past this request's stop
                        req.position += 1
                        self._emit(req, int(row[slot]))
            self._last_readback = done

    def _observe_readback(self, kind: str, wait_s: float) -> None:
        """One device-completion wait, by dispatch kind: the readback
        histogram, the estimator's averages and a timeline span."""
        _M_READBACK.labels(kind=kind).observe(wait_s, trace_id=None)
        self._telemetry.record_readback(kind, wait_s)
        if self._dtl is not None:
            self._dtl.record_readback(kind, wait_s)

    def _emit_spec(self, kind: str, host, rows) -> None:
        """Reader thread: a landed verify (``spec``: ``(out, accepted)``,
        each row's tokens ``out[slot, :accepted + 1]``) or a zero-draft
        block (``spec_block``: the ``[block, B]`` slab), counted as one
        decode block; rows past their stop are skipped token by token."""
        snapshot, t_dispatch, t_done = rows
        counters = self._reader_counters
        counters["decode_blocks"] += 1
        counters["decode_row_dispatches"] += len(snapshot)
        counters["decode_time_s"] += t_done - max(t_dispatch, self._last_readback)
        self._last_readback = t_done
        if kind == "spec":
            out_np, acc_np = host
            counters["decode_steps"] += 1
            counters["decode_rows"] += len(snapshot)
            for slot, req in snapshot:
                for token in out_np[slot, : int(acc_np[slot]) + 1]:
                    if req.finished:
                        break
                    req.position += 1
                    self._emit(req, int(token))
            return
        counters["decode_steps"] += len(host)
        counters["decode_rows"] += len(host) * len(snapshot)
        for row in host:
            for slot, req in snapshot:
                if req.finished:
                    continue
                req.position += 1
                self._emit(req, int(row[slot]))

    def _emit(self, req: _Request, token: int) -> None:
        """Reader thread: one token to the request's queue; a finished
        request gets its end and its slot goes back to the dispatch loop."""
        req.generated += 1
        req.emitted.append(token)
        self._reader_counters["tokens_generated"] += 1
        _M_TOKENS.inc()
        now = time.time()
        if req.generated == 1:
            ttft = now - req.t_submit
            self._ttft.append(ttft)
            _M_TTFT.observe(ttft, trace_id=req.trace_hex)
            _M_PREFILL_WAIT.observe(now - (req.t_admit or req.t_submit), trace_id=req.trace_hex)
            slo_mod.observe_latency("ttft_p95", ttft)
            flight_recorder.event_rid(req.rid, "first_token", ttft_s=round(ttft, 6))
        elif req.t_last_token:
            itl = now - req.t_last_token
            _M_TOKEN_LATENCY.observe(itl, trace_id=req.trace_hex)
            slo_mod.observe_latency("inter_token_p95", itl)
        req.t_last_token = now
        done = (
            token in self._stop_ids
            or req.generated >= req.params.max_tokens
            or req.position >= self.max_seq_len - 1
            or req.cancelled
        )
        if token not in self._stop_ids:
            req.out_queue.put(token)
        if done:
            self._finish(req)
            slot = req.slot
            if slot >= 0:
                self._release_q.put((slot, req))
                with self._lock:
                    self._lock.notify_all()

    @staticmethod
    def _finish(req: _Request, outcome: Optional[str] = None) -> None:
        """End the request's stream once; its flight record learns the
        outcome (from the request's state unless given)."""
        if not req.finished:
            req.finished = True
            req.out_queue.put(_END)
            if outcome is None:
                if isinstance(req.error, RequestPreempted):
                    outcome = "preempt"
                elif req.error is not None:
                    outcome = "error"
                else:
                    outcome = "abort" if req.cancelled else "finish"
            flight_recorder.finish_rid(req.rid, outcome)


# --------------------------------------------------------------------- #
# The verify programs (JAX ``spec_verify`` and ``spec_verify_paged``)


def _spec_accept(logits, tokens, positions, offsets, temps, topps, seeds, draft, draft_len,
                 live, *, max_pos: int, vocab: int, sampled: bool):
    """Sample each of the K+1 verify positions with the keys plain decode
    would use (output j lands at ``offsets + 1 + j``, clamped to
    ``max_pos``), accept each row's leading run of draft tokens equal to
    the outputs at the same index, and advance live rows past it plus the
    bonus token ``out[row, accepted]``. Returns (new tokens, new
    positions, packed ``[B, K+2]``: the outputs, then the accepted
    count)."""
    B, Kd = draft.shape
    Kp1 = Kd + 1
    device = logits.device
    pos_grid = torch.clamp(offsets.long()[:, None] + 1 + torch.arange(Kp1, device=device)[None, :],
                           max=max_pos)
    keys = None
    if sampled:
        keys = sampling.sample_keys(seeds.repeat_interleave(Kp1), pos_grid.reshape(-1))
    out = sampling.sample_tokens(
        logits[..., :vocab].reshape(B * Kp1, vocab), temps.repeat_interleave(Kp1),
        topps.repeat_interleave(Kp1), keys,
    ).reshape(B, Kp1)
    drafted = torch.arange(Kd, device=device)[None, :] < draft_len[:, None]
    match = (draft == out[:, :Kd]) & drafted
    accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
    rows = torch.arange(B, device=device)
    new_tokens = torch.where(live, out[rows, accepted], tokens)
    new_positions = torch.where(live, torch.clamp(positions + accepted + 1, max=max_pos), positions)
    return new_tokens, new_positions, torch.cat([out, accepted[:, None]], dim=1)


def _verify_chunk(tokens, positions, draft, draft_len, live):
    """Every slot's verify chunk ``[last token ++ draft]`` at its position,
    ``valid = 1 + draft_len`` on live rows and 0 on dead ones: (offsets,
    chunk, valid, slots)."""
    offsets = torch.where(live, positions, 0)
    chunk = torch.cat([tokens[:, None], draft], dim=1)
    valid = torch.where(live, 1 + draft_len, 0)
    return offsets, chunk, valid, torch.arange(draft.shape[0], device=chunk.device)


def spec_verify(params, cfg, caches, tokens, positions, temps, topps, seeds, draft, draft_len,
                live, window: int, *, max_pos: int, vocab: int, sampled: bool,
                quant_kernel=None, tp=None):
    """The fixed layout's verify: :func:`_verify_chunk` through
    ``llama.verify_layers`` (shard by shard under ``tp``), then
    :func:`_spec_accept` on the first shard's device."""
    offsets, chunk, valid, slots = _verify_chunk(tokens, positions, draft, draft_len, live)
    logits, _ = llama.verify_layers(
        params, cfg, chunk, offsets, valid, slots, caches, window, quant_kernel=quant_kernel,
        tp=tp,
    )
    return _spec_accept(logits, tokens, positions, offsets, temps, topps, seeds, draft, draft_len,
                        live, max_pos=max_pos, vocab=vocab, sampled=sampled)


def spec_verify_paged(params, cfg, caches, tokens, positions, temps, topps, seeds, draft,
                      draft_len, live, window: int, tables, page_size: int, *, max_pos: int,
                      vocab: int, sampled: bool, quant_kernel=None, page_kernel=None, tp=None):
    """:func:`spec_verify` over the page pool (``llama.verify_layers_paged``);
    ``page_kernel`` reads the K+1 query rows through the page kernel
    (``paged_attention_tp`` on each shard's heads under ``tp``)."""
    offsets, chunk, valid, slots = _verify_chunk(tokens, positions, draft, draft_len, live)
    logits, _ = llama.verify_layers_paged(
        params, cfg, chunk, offsets, valid, slots, tables, caches, window, page_size,
        quant_kernel=quant_kernel, page_kernel=page_kernel, tp=tp,
    )
    return _spec_accept(logits, tokens, positions, offsets, temps, topps, seeds, draft, draft_len,
                        live, max_pos=max_pos, vocab=vocab, sampled=sampled)


_ENGINE_LOCK = threading.Lock()
_ENGINE: Optional[LLMEngine] = None  # guarded by _ENGINE_LOCK


def get_engine(config: Optional[EngineConfig] = None, device=None) -> LLMEngine:
    """Process-wide engine singleton, on the card unless ``device`` says
    otherwise (weights live once there); ``config=None`` reads the
    configuration file and the ``APP_ENGINE_*`` environment
    (``config.load_config``), as JAX's reads ``get_config().engine``."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            if config is None:
                from generativeaiexamples_tpu_torch.config import load_config

                config = load_config().engine
            _ENGINE = LLMEngine(config, device=device)
        return _ENGINE


def live_queue_depth() -> Optional[int]:
    """Admission-queue depth of the process engine (``get_engine``), or None
    when none was built. Never builds one."""
    with _ENGINE_LOCK:
        eng = _ENGINE
    if eng is None:
        return None
    return eng.queue_depth()
