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
Speculative decoding, disaggregation, snapshots, drain, the flight
recorder and telemetry are not ported yet.

The engine runs on the card: ``device=None`` means CUDA and raises when
no card is present. Tests pass ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.
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
from generativeaiexamples_tpu_torch.engine import kv_pages, prefix_cache
from generativeaiexamples_tpu_torch.engine.scheduler.unified import UnifiedPolicy
from generativeaiexamples_tpu_torch.engine.tokenizer import load_tokenizer
from generativeaiexamples_tpu_torch.models import llama, sampling
from generativeaiexamples_tpu_torch.ops import (
    decode_attention, flash_attention, int8_matmul, page_attention, quant,
)

logger = logging.getLogger(__name__)


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
    cancelled: bool = False
    finished: bool = False
    error: Optional[BaseException] = None
    # the matched prefix-cache entry, pinned until its rows are secured
    # (the fixed fetch or the paged retain), and the rows it serves
    prefix_entry: Optional[prefix_cache.PrefixEntry] = None
    prefix_len: int = 0


_END = None  # sentinel on out_queue
_REQ_IDS = itertools.count(1)
_UNSEEDED_RNG = random.SystemRandom()


class EngineOverloaded(Exception):
    """The typed load-shedding signal of ``submit`` (``max_queued_requests``
    reached), with the suggested Retry-After in seconds: the port's copy of
    the JAX package's ``utils.resilience.EngineOverloaded``."""

    def __init__(self, message: str = "engine overloaded", retry_after: float = 1.0):
        self.retry_after = retry_after
        super().__init__(message)


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


def _prefix_store_extra_slots(cfg: EngineConfig) -> int:
    """Prefix-cache slots the config asks for: each reserves one
    ``max_seq_len`` strip (pool pages on the paged layout, a store slot
    on the fixed one). The port always chunks and is always layered, the
    two other conditions of the JAX rule."""
    if cfg.prefix_cache_enable != "off":
        return cfg.prefix_cache_slots
    return 0


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
    ):
        cfg = config or EngineConfig()
        cfg.validate()
        self.engine_config = cfg
        self.device = resolve_device(device)
        if cfg.model_config_name not in llama.PRESETS:
            raise ValueError(f"unknown model_config_name {cfg.model_config_name!r}")
        model_cfg = llama.PRESETS[cfg.model_config_name]
        self.model_config = model_cfg
        self.tokenizer = load_tokenizer(cfg.tokenizer_path)
        # Sample only ids the tokenizer can represent (the byte tokenizer
        # under a 128k-vocab head would otherwise stream blanks).
        tok_vocab = getattr(self.tokenizer, "vocab_size", 0) or model_cfg.vocab_size
        self._sample_vocab = min(model_cfg.vocab_size, max(tok_vocab, 1))
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]
        self.num_slots = cfg.max_batch_size
        self.max_seq_len = min(cfg.max_seq_len, model_cfg.max_seq_len)
        self._page = cfg.page_size
        self._decode_block = cfg.decode_block
        if cfg.kv_layout == "auto":
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
            # whatever the runahead (_decode_once)
            self._page_slack = cfg.decode_block + 1

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
        # is read by the einsum attention, as in JAX)
        self._page_kernel = self._paged and page_attention.supports_geometry(
            self._page, model_cfg.head_dim, model_cfg.num_heads, model_cfg.num_kv_heads,
            kv_dtype=cfg.kv_cache_dtype,
        )
        self._kv_kernel = (
            not self._paged and self._kv_quant and decode_attention.supported(
                self.max_seq_len, model_cfg.head_dim, model_cfg.num_heads,
                model_cfg.num_kv_heads,
            )
        )
        if self.device.type == "cuda":
            self._check_kernels(cfg, model_cfg, dtype)

        if params is None:
            if cfg.quantization in ("int8", "w8a8"):
                params = quant.init_packed_params_int8(model_cfg, 0, dtype, self.device)
            else:
                params = llama.init_params(model_cfg, 0, dtype, self.device)
            logger.warning("LLM engine running with random-init weights (no checkpoint).")
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
                quantized=self._kv_quant, packed=self._kv_packed,
            )
            self._kv_alloc = kv_pages.PageAllocator(self._pool_pages, self._page)
            self._tables = torch.zeros(
                (self.num_slots, self._max_pages_per_slot), dtype=torch.int32, device=self.device
            )
        else:
            self._cache = llama.init_kv_cache_layers(
                model_cfg, self.num_slots, self.max_seq_len, dtype, self.device,
                quantized=self._kv_quant,
            )
        self._init_prefix_cache(cfg, model_cfg, dtype)
        self._stop_ids = set(self.tokenizer.stop_ids())

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
        self._slot_pages: Dict[int, List[int]] = {}
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        # Host shadows: decode steps left before each slot's request
        # exhausts its budget, and each slot's decode position, both moved
        # by decode_block per dispatch. They free a slot without waiting
        # for its readback and pick the attention window.
        self._slot_budget: Dict[int, int] = {}
        self._slot_pos: Dict[int, int] = {}
        # every key exists up front: stats() copies these dicts from other
        # threads; the dispatch thread counts prefill, the reader decode
        self._counters = collections.Counter(dict.fromkeys((
            "prefill_waves", "prefill_tokens", "prefill_chunks", "requests_prefilled",
            "prefix_copy_dispatches",
        ), 0))
        self._reader_counters = collections.Counter(dict.fromkeys((
            "decode_blocks", "decode_steps", "decode_rows", "decode_time_s",
            "tokens_generated", "readbacks",
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
        # the co-scheduling seam the retrieval micro-batcher waits on
        self.scheduler = UnifiedPolicy(self)
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

    # ------------------------------------------------------------------ #
    # build-time checks

    def _check_kernels(self, cfg: EngineConfig, model_cfg, dtype) -> None:
        """On the card every kernel of the serving path must serve this
        geometry: a refusal is an error here, not a silent fall back."""
        if dtype != torch.bfloat16:
            raise ValueError("the CUDA kernels serve dtype='bfloat16' only")
        if self._paged and not self._page_kernel:
            raise ValueError(
                f"paged attention kernel refuses page_size={cfg.page_size} "
                f"head_dim={model_cfg.head_dim} heads={model_cfg.num_heads} "
                f"kv_heads={model_cfg.num_kv_heads} kv_cache_dtype={cfg.kv_cache_dtype}"
            )
        if not self._paged and self._kv_quant and not self._kv_kernel:
            raise ValueError(
                f"decode attention kernel refuses the int8 fixed cache max_seq_len="
                f"{self.max_seq_len} head_dim={model_cfg.head_dim} "
                f"heads={model_cfg.num_heads} kv_heads={model_cfg.num_kv_heads}"
            )
        bucket = min(cfg.prefill_chunk, self.max_seq_len)
        if bucket >= flash_attention.MIN_T and not flash_attention.supported(
            bucket, model_cfg.head_dim
        ):
            raise ValueError(f"flash attention kernel refuses head_dim={model_cfg.head_dim}")

    @staticmethod
    def _packs(params):
        for lp in params["layers"]:
            for val in lp.values():
                if isinstance(val, dict):
                    yield val
        if isinstance(params.get("lm_head"), dict):
            yield params["lm_head"]

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
        if P <= 0:
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
            return sum(t.numel() * t.element_size() for c in self._prefix_store for t in c.values())
        per_page = sum(t[0].numel() * t.element_size() for c in self._cache for t in c.values())
        return self._prefix.capacity * self._max_pages_per_slot * per_page

    def _drop_prefix_pages(self, entry: prefix_cache.PrefixEntry) -> None:
        """Prefix-cache drop hook (paged layout): an entry leaving the
        index releases its refcounted pool pages. Runs under the index's
        lock; the allocator has its own and never calls back."""
        if entry.pages:
            self._kv_alloc.release(entry.pages)
        entry.pages = None

    # ------------------------------------------------------------------ #
    # public API

    def submit(self, prompt_ids: Sequence[int], params: Optional[SamplingParams] = None) -> _Request:
        """Submit a request; returns its handle. Over-long prompts keep
        their tail, with room for at least min(64, max_tokens) tokens.
        Raises ``EngineOverloaded`` when ``max_queued_requests`` requests
        already wait for a slot."""
        params = params or SamplingParams()
        reserve = max(1, min(64, params.max_tokens))
        keep = max(1, self.max_seq_len - 1 - reserve)
        req = _Request(
            rid=next(_REQ_IDS),
            prompt_ids=list(prompt_ids)[-keep:],
            params=params,
            sampling_seed=params.seed or _UNSEEDED_RNG.getrandbits(31),
            t_submit=time.time(),
        )
        if self._prefix is not None and params.prefix_hint:
            # session keep-alive: the hinted entry's recency is bumped
            # before admission, so other traffic cannot evict it meanwhile
            self._prefix.touch(params.prefix_hint)
        cap = self.engine_config.max_queued_requests
        with self._lock:
            if not self._running:
                raise RuntimeError("LLM engine is shut down")
            if cap > 0 and len(self._pending) >= cap:
                raise EngineOverloaded(
                    f"engine admission queue full ({len(self._pending)}/{cap} pending)"
                )
            self._pending.append(req)
            self._lock.notify_all()
        return req

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
                )
            if req is None or req.finished or req.cancelled:
                return False
            req.cancelled = True
            if req in self._pending:
                self._pending.remove(req)
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

    def _stream_from(self, req: _Request, params: SamplingParams, timeout: Optional[float]):
        ids: List[int] = []
        emitted = ""
        stops = [s for s in params.stop if s]
        stall_s = float(self.engine_config.stream_timeout_s) if timeout is None else None
        deadline = None if timeout is None else time.time() + timeout
        try:
            while True:
                item = _next_stream_item(req.out_queue, stall_s, deadline)
                if item is _END:
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

    def stats(self) -> Dict[str, float]:
        """Serving counters: prefill waves, tokens (whole prompts, cached
        prefixes included) and chunks, and the requests prefilled (each
        admitted request once); the prefix cache's hits, misses,
        evictions, tokens reused, pages mapped (paged) and store copies
        (fixed, ``prefix_copy_dispatches``); decode
        blocks, steps, rows and wall time; tokens emitted; TTFTs (submit to
        the reader's emission of the first token); and, on the paged
        layout, the page allocator's state.

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
            live = list(self._slot_req.items())
        for slot, req in live:
            self._release(slot, req)
        return True

    # ------------------------------------------------------------------ #
    # watchdog thread

    def _mark_wedged(self, reason: str) -> None:
        self._wedged = True
        ENGINE_WEDGED.set()
        logger.error("LLM engine wedged: %s", reason)

    def _clear_wedged(self) -> None:
        if self._wedged:
            self._wedged = False
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
                while (
                    self._running and not self.scheduler.has_work() and not self._slot_req
                    and self._release_q.empty()
                ):
                    self._last_progress = time.time()  # waiting idle is progress
                    self._lock.wait(timeout=1.0)
                running = self._running
                self._last_progress = time.time()
            if not running:
                break
            try:
                with torch.inference_mode():
                    self._drain_releases()
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
        with self._lock:
            pending = list(self._pending)
            self._pending.clear()
        for req in pending:
            self._finish(req)
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
        event = None
        if tensor.is_cuda:
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = tensor
        self._readback.put((kind, host, event, rows))

    def _max_wave_rows(self, bucket: int) -> int:
        """Max prefill rows for this bucket under prefill_wave_tokens."""
        budget = self.engine_config.prefill_wave_tokens
        return max(1, min(self.num_slots, budget // max(1, bucket)))

    def _admit(self) -> None:
        """Claim a wave of pending requests for the free slots, fund their
        pages, and prefill them (short prompts in one monolithic wave,
        long ones by chunks). Every dispatch of a wave is one bucket wide
        (``prefill_chunk``, or ``max_seq_len`` when that is shorter), so
        ``prefill_wave_tokens`` caps the wave at ``_max_wave_rows`` of it."""
        with self._lock:
            if self._paused:
                return
            limit = min(len(self._free_slots), self._max_wave_rows(self._prefill_bucket(1)))
            claimed = []
            while self._pending and len(claimed) < limit:
                req = self._pending.popleft()
                self._register(req, self._free_slots.pop())
                claimed.append(req)
        if not claimed:
            return
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
        funded = self._fund(claimed)
        short = [r for r in funded if len(r.prompt_ids) <= chunk]
        long = [r for r in funded if len(r.prompt_ids) > chunk]
        for wave, chunked in ((short, False), (long, True)):
            if wave:
                self._prefill_wave(wave, chunked)

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
                    self._release(r.slot, r)  # unpins a later claim's match
                    r.prefix_len = 0
                with self._lock:
                    self._pending.extendleft(reversed(back))
                break
            self._kv_alloc.record_prefix_mapped(len(shared))
            self._slot_pages[req.slot] = shared + fresh
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

    def _prefill_wave(self, reqs: List[_Request], chunked: bool) -> None:
        cfg = self.model_config
        N = len(reqs)
        lengths = np.array([len(r.prompt_ids) for r in reqs], np.int64)
        bucket = self._prefill_bucket(int(lengths.max()))
        tokens = np.zeros((N, bucket), np.int64)
        for i, req in enumerate(reqs):
            tokens[i, : lengths[i]] = req.prompt_ids
        slots = self._to_device([r.slot for r in reqs], torch.long)
        lengths_d = self._to_device(lengths, torch.long)
        if chunked:
            cached = None
            if self._prefix is not None:
                cached = np.array([r.prefix_len for r in reqs], np.int64)
                if not self._paged:
                    self._fetch_prefixes(reqs)
            last_h = self._prefill_chunked(tokens, lengths, slots, cached)
            logits = llama._head(self.params, last_h[:, None, :], cfg, self._quant_kernel)[:, 0, :]
        else:
            logits, kvs = llama.prefill_layers(
                self.params, cfg, self._to_device(tokens, torch.long), lengths_d,
                quant_kernel=self._quant_kernel,
            )
            if self._paged:
                llama.write_prefill_pages(self._cache, kvs, self._tables[slots], self._page)
            else:
                llama.write_prefill_slots(self._cache, kvs, slots)
            del kvs
        temps = self._to_device([r.params.temperature for r in reqs], torch.float32)
        topps = self._to_device([r.params.top_p for r in reqs], torch.float32)
        seeds = self._to_device([r.sampling_seed & 0x7FFFFFFF for r in reqs], torch.long)
        keys = None
        if any(r.params.temperature > 0 for r in reqs):
            keys = sampling.sample_keys(seeds, lengths_d)  # the first token is keyed at T
        first = sampling.sample_tokens(logits[:, : self._sample_vocab], temps, topps, keys)
        self._update_slots(slots, first, lengths_d, temps, topps, seeds)
        self._counters["prefill_waves"] += 1
        self._counters["prefill_tokens"] += int(lengths.sum())
        self._counters["requests_prefilled"] += len(reqs)
        for req, n in zip(reqs, lengths):
            req.position = int(n)
        self._to_reader("prefill", first, list(enumerate(reqs)))
        if chunked and self._prefix is not None:
            self._insert_prefixes(reqs)

    def _fetch_prefixes(self, reqs: List[_Request]) -> None:
        """Fixed layout: copy each hit's cached rows from the prefix store
        into its slot before the first chunk reads them, then unpin the
        entry: any later write of the store slot (an insert after an
        eviction) is ordered behind this copy on the stream."""
        for req in reqs:
            ent = req.prefix_entry
            if ent is None:
                continue
            llama.copy_kv_rows(self._prefix_store, self._cache, ent.store_slot, req.slot,
                               req.prefix_len)
            self._counters["prefix_copy_dispatches"] += 1
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
            llama.copy_kv_rows(self._cache, self._prefix_store, req.slot, store_slot, length)
            self._counters["prefix_copy_dispatches"] += 1

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
        its own."""
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
            valid = np.clip(lengths - k * C, 0, C)
            if cached is not None:
                valid = np.where(k * C < cached, 0, valid)
            valid = self._to_device(valid, torch.long)
            offsets = torch.full((N,), k * C, dtype=torch.long, device=dev)
            window = self._attention_window(min((k + 1) * C, self.max_seq_len))
            tok_d = self._to_device(tok_k, torch.long)
            if self._paged:
                cand, _ = llama.extend_layers_paged(
                    self.params, self.model_config, tok_d, offsets, valid, slots,
                    self._tables, self._cache, window, self._page,
                    quant_kernel=self._quant_kernel,
                )
            else:
                cand, _ = llama.extend_layers(
                    self.params, self.model_config, tok_d, offsets, valid, slots,
                    self._cache, window, quant_kernel=self._quant_kernel,
                )
            last_h = torch.where((valid > 0)[:, None], cand, last_h)
            self._counters["prefill_chunks"] += 1
        return last_h

    def _decode_once(self) -> None:
        """One block of ``decode_block`` steps over every slot, from and
        into the device-resident slot state. Budget-exhausted, finished
        and cancelled slots are freed first, so pending requests take them
        instead of dead steps; the reader still emits the final tokens of
        budget-exhausted requests from the slabs already dispatched (the
        snapshot pins rows to their requests).

        A slot is dispatched only while its budget is positive, so it
        writes at most ``decode_block - 1`` positions past its last token:
        the ``decode_block + 1`` pages of slack funded at admission
        (``_page_slack``) bound it, whatever the runahead."""
        block = self._decode_block
        with self._lock:
            self._release_finished_slots()
            if not self._slot_req:
                return
            snapshot = sorted(self._slot_req.items())
            window = self._decode_window(max(self._slot_pos.values()))
            sampled = any(req.params.temperature > 0 for _, req in snapshot)
            for slot in self._slot_pos:
                self._slot_pos[slot] += block
                self._slot_budget[slot] -= block
        t_dispatch = time.perf_counter()
        max_pos = self.max_seq_len - 1
        tok = self._tokens_dev
        pos = torch.where(self._live_dev, self._positions_dev, 0)
        keys = None
        if sampled:
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
                    quant_kernel=self._quant_kernel, page_kernel=self._page_kernel,
                )
            else:
                logits, _ = llama.decode_layers(
                    self.params, self.model_config, tok, pos, self._cache,
                    window=window, quant_kernel=self._quant_kernel, kv_kernel=self._kv_kernel,
                )
            tok = sampling.sample_tokens(
                logits[:, : self._sample_vocab], self._temps_dev, self._topps_dev,
                None if keys is None else (keys[0][s], keys[1][s]),
            )
            token_slab.append(tok)
            pos = torch.clamp(pos + 1, max=max_pos)
        self._tokens_dev.copy_(tok)
        self._positions_dev.copy_(pos)
        # a tensor of its own: admission rewrites _tokens_dev in place while
        # this slab may still be on its way to the host
        self._to_reader("decode", torch.stack(token_slab), (snapshot, t_dispatch))

    def _release_finished_slots(self) -> None:
        """Free budget-exhausted, finished and cancelled slots before a
        dispatch (caller holds self._lock). A cancelled request gets its
        end here: once the slot is recycled no readback finishes it."""
        for slot, req in list(self._slot_req.items()):
            if req.cancelled or req.finished or self._slot_budget[slot] <= 0:
                if req.cancelled:
                    self._finish(req)
                self._release(slot, req)

    def _release(self, slot: int, req: _Request) -> None:
        """Free ``slot`` while it still belongs to ``req`` (a late release
        of an earlier owner is a no-op), its prefix pin if it still holds
        one and, on the paged layout, its pages; its table row points back
        at the scratch page. Dispatch thread only (or after the threads
        ended, at shutdown). Blocks already dispatched for the slot run before
        anything a new owner enqueues, so its pages and strip are reusable
        at once."""
        with self._lock:
            if self._slot_req.get(slot) is not req:
                return
            # the pin and the pages go first: a request gone from _slot_req
            # holds neither (the allocator's and the index's locks are
            # leaves, taken under this one)
            if req.prefix_entry is not None:
                # a match whose rows were never secured (requeue, a failed wave)
                self._prefix.release(req.prefix_entry)
                req.prefix_entry = None
            pages = self._slot_pages.pop(slot, None)
            if pages:
                # shared prefix pages keep the entry's reference
                self._kv_alloc.release(pages)
            del self._slot_req[slot]
            self._slot_budget.pop(slot, None)
            self._slot_pos.pop(slot, None)
            req.slot = -1
            self._free_slots.append(slot)
            self._lock.notify_all()  # wakes ingest_window when the last slot frees
        if self._paged:
            self._tables[slot].fill_(0)
        self._live_dev[slot].fill_(False)
        self._positions_dev[slot].fill_(0)

    # ------------------------------------------------------------------ #
    # reader thread: the one place that waits for the device

    def _reader_loop(self) -> None:
        while True:
            item = self._readback.get()
            if item is None:  # shutdown: every earlier item was emitted
                with self._lock:
                    live = list(self._slot_req.values())
                for req in live:
                    self._finish(req)
                return
            kind, host, event, rows = item
            try:
                if event is not None:
                    event.synchronize()  # releases the GIL while it waits
                values = host.numpy()
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
                counters["decode_time_s"] += done - max(t_dispatch, self._last_readback)
                for row in values:
                    for slot, req in snapshot:
                        if req.finished:
                            continue  # overran past this request's stop
                        req.position += 1
                        self._emit(req, int(row[slot]))
            self._last_readback = done

    def _emit(self, req: _Request, token: int) -> None:
        """Reader thread: one token to the request's queue; a finished
        request gets its end and its slot goes back to the dispatch loop."""
        req.generated += 1
        self._reader_counters["tokens_generated"] += 1
        if req.generated == 1:
            self._ttft.append(time.time() - req.t_submit)
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
    def _finish(req: _Request) -> None:
        if not req.finished:
            req.finished = True
            req.out_queue.put(_END)


_ENGINE_LOCK = threading.Lock()
_ENGINE: Optional[LLMEngine] = None  # guarded by _ENGINE_LOCK


def get_engine(config: Optional[EngineConfig] = None, device=None) -> LLMEngine:
    """Process-wide engine singleton, on the card unless ``device`` says
    otherwise (weights live once there); ``config=None`` reads the
    ``APP_ENGINE_*`` environment (``EngineConfig.from_env``)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = LLMEngine(config or EngineConfig.from_env(), device=device)
        return _ENGINE


def live_queue_depth() -> Optional[int]:
    """Admission-queue depth of the process engine (``get_engine``), or None
    when none was built. Never builds one."""
    with _ENGINE_LOCK:
        eng = _ENGINE
    if eng is None:
        return None
    return eng.queue_depth()
