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

One named daemon thread (``_loop``) does all device work:

1. admits waves of pending requests up to ``max_batch_size`` slots; on
   the paged layout it funds each with every page it can touch (``_fund``),
   a fixed slot always holds ``max_seq_len`` rows;
2. prefills prompts of up to ``prefill_chunk`` tokens monolithically
   (``llama.prefill_layers`` + ``write_prefill_pages`` or
   ``write_prefill_slots``; the flash kernel serves the wave from T = 512),
   and longer prompts chunk by chunk (``llama.extend_layers_paged`` or
   ``llama.extend_layers``);
3. decodes all slots in blocks of ``decode_block`` steps
   (``llama.decode_layers_paged`` with the paged-attention kernel, or
   ``llama.decode_layers`` with the decode-attention kernel over an int8
   fixed cache; the int8 or W8A8 matmul kernel serves every projection),
   greedy or sampled with the JAX package's threefry keys, with one
   device-to-host copy of the block's tokens;
4. emits tokens to each request's queue, with stop ids and
   ``max_tokens``, and releases finished slots and their pages.

Dead slots decode at position 0: on the paged layout they write the
scratch page, on the fixed layout row 0 of their own strip, as in JAX.
Prefix caching, speculative decoding, disaggregation, snapshots, drain, the flight
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
from generativeaiexamples_tpu_torch.engine import kv_pages
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
    emitted: List[int] = dataclasses.field(default_factory=list)
    cancelled: bool = False
    finished: bool = False
    error: Optional[BaseException] = None


_END = None  # sentinel on out_queue
_REQ_IDS = itertools.count(1)
_UNSEEDED_RNG = random.SystemRandom()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present is an
    error, never a quiet fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "LLMEngine runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU (tests)"
        )
    return dev


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
            self._pool_pages = kv_pages.pool_pages(cfg, self.max_seq_len)
            kv_pages.validate_runtime(self._page, self.max_seq_len, self._pool_pages)
            self._max_pages_per_slot = kv_pages.pages_for_tokens(self.max_seq_len, self._page)
            # a decode block can write up to a block past a request's budget
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
        self._stop_ids = set(self.tokenizer.stop_ids())

        # Dispatch-thread state: only _loop and what it calls touch these.
        self._slot_req: Dict[int, _Request] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._free_slots = list(range(self.num_slots - 1, -1, -1))
        # every key exists up front: stats() copies this dict from other
        # threads while the dispatch thread increments it
        self._counters = collections.Counter(dict.fromkeys((
            "prefill_waves", "prefill_tokens", "prefill_chunks", "decode_blocks",
            "decode_steps", "decode_rows", "decode_time_s", "tokens_generated",
        ), 0))
        self._ttft: "collections.deque[float]" = collections.deque(maxlen=4096)

        self._lock = threading.Condition()
        self._pending: "collections.deque[_Request]" = collections.deque()  # guarded by self._lock
        self._running = True  # guarded by self._lock
        self._thread = threading.Thread(target=self._loop, name="torch-llm-engine", daemon=True)
        self._thread.start()

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

    # ------------------------------------------------------------------ #
    # public API

    def submit(self, prompt_ids: Sequence[int], params: Optional[SamplingParams] = None) -> _Request:
        """Submit a request; returns its handle. Over-long prompts keep
        their tail, with room for at least min(64, max_tokens) tokens."""
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
        with self._lock:
            if not self._running:
                raise RuntimeError("LLM engine is shut down")
            self._pending.append(req)
            self._lock.notify_all()
        return req

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
                    (r for r in list(self._slot_req.values()) if r.rid == rid), None
                )
            if req is None or req.finished or req.cancelled:
                return False
            req.cancelled = True
            if req in self._pending:
                self._pending.remove(req)
                req.finished = True
                req.out_queue.put(_END)
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

    def stats(self) -> Dict[str, float]:
        """Serving counters: prefill waves and chunks, decode blocks,
        steps and tokens, decode wall time on the dispatch thread (device
        work included: each block ends in a device-to-host copy), TTFTs,
        and, on the paged layout, the page allocator's state."""
        out: Dict[str, float] = dict(self._counters)
        ttft = list(self._ttft)
        if ttft:
            out["ttft_mean_s"] = sum(ttft) / len(ttft)
            out["ttft_max_s"] = max(ttft)
        if self._kv_alloc is not None:
            out.update(self._kv_alloc.stats())
        return out

    def shutdown(self, timeout: float = 60.0) -> bool:
        """Stop the dispatch thread; every live stream ends. Returns True
        when the thread exited within ``timeout``."""
        with self._lock:
            self._running = False
            self._lock.notify_all()
        self._thread.join(timeout)
        return not self._thread.is_alive()

    # ------------------------------------------------------------------ #
    # dispatch thread

    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._running and not self._pending and not self._slot_req:
                    self._lock.wait(timeout=1.0)
                running = self._running
            if not running:
                break
            try:
                with torch.inference_mode():
                    self._admit()
                    self._release_finished()
                    if self._slot_req:
                        self._decode_once()
            except Exception as exc:  # noqa: BLE001 - the serving loop must survive
                logger.exception("LLM engine dispatch error: %s", exc)
                for slot, req in list(self._slot_req.items()):
                    req.error = exc
                    self._finish(req)
                    self._release(slot)
        for slot, req in list(self._slot_req.items()):
            self._finish(req)
            self._release(slot)
        with self._lock:
            while self._pending:
                self._finish(self._pending.popleft())

    def _admit(self) -> None:
        """Claim a wave of pending requests for the free slots, fund their
        pages, and prefill them (short prompts in one monolithic wave,
        long ones by chunks)."""
        with self._lock:
            claimed = []
            while self._pending and len(claimed) < len(self._free_slots):
                claimed.append(self._pending.popleft())
        if not claimed:
            return
        for req in claimed:
            req.slot = self._free_slots.pop()
        funded = self._fund(claimed)
        chunk = self.engine_config.prefill_chunk
        short = [r for r in funded if len(r.prompt_ids) <= chunk]
        long = [r for r in funded if len(r.prompt_ids) > chunk]
        for wave, chunked in ((short, False), (long, True)):
            if wave:
                self._prefill_wave(wave, chunked)

    def _fund(self, claimed: List[_Request]) -> List[_Request]:
        """Reserve every page each claimed request can touch and write the
        funded rows' page tables to the device. A request the pool cannot
        fund goes back to the queue front with every later claim (OOM
        backpressure, FIFO order kept). A fixed slot always holds
        ``max_seq_len`` rows: every claim is funded."""
        if not self._paged:
            return claimed
        funded: List[_Request] = []
        for idx, req in enumerate(claimed):
            total = kv_pages.pages_needed(
                len(req.prompt_ids), req.params.max_tokens, self._page,
                self.max_seq_len, self._page_slack,
            )
            pages = self._kv_alloc.alloc(total)
            if pages is None:
                with self._lock:
                    for r in reversed(claimed[idx:]):
                        self._free_slots.append(r.slot)
                        r.slot = -1
                        self._pending.appendleft(r)
                break
            self._slot_pages[req.slot] = pages
            funded.append(req)
        if funded:
            rows = torch.zeros((len(funded), self._max_pages_per_slot), dtype=torch.int32)
            for i, req in enumerate(funded):
                pages = self._slot_pages[req.slot]
                rows[i, : len(pages)] = torch.tensor(pages, dtype=torch.int32)
            slots = torch.tensor([r.slot for r in funded], dtype=torch.long)
            self._tables[slots.to(self.device)] = rows.to(self.device)
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
        dev = self.device
        N = len(reqs)
        lengths = np.array([len(r.prompt_ids) for r in reqs], np.int64)
        bucket = self._prefill_bucket(int(lengths.max()))
        tokens = np.zeros((N, bucket), np.int64)
        for i, req in enumerate(reqs):
            tokens[i, : lengths[i]] = req.prompt_ids
            self._slot_req[req.slot] = req  # from here the loop's error handler owns it
        slots = torch.tensor([r.slot for r in reqs], dtype=torch.long, device=dev)
        if chunked:
            last_h = self._prefill_chunked(tokens, lengths, slots)
            logits = llama._head(self.params, last_h[:, None, :], cfg, self._quant_kernel)[:, 0, :]
        else:
            logits, kvs = llama.prefill_layers(
                self.params, cfg, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(lengths).to(dev), quant_kernel=self._quant_kernel,
            )
            if self._paged:
                llama.write_prefill_pages(self._cache, kvs, self._tables[slots], self._page)
            else:
                llama.write_prefill_slots(self._cache, kvs, slots)
            del kvs
        first = self._sample(logits, reqs, [int(n) for n in lengths]).tolist()
        self._counters["prefill_waves"] += 1
        self._counters["prefill_tokens"] += int(lengths.sum())
        for req, n, token in zip(reqs, lengths, first):
            req.position = int(n)
            self._emit(req, int(token))

    def _prefill_chunked(self, tokens: np.ndarray, lengths: np.ndarray, slots: torch.Tensor):
        """Chunk k extends every row by up to prefill_chunk tokens at offset
        k * C (rows whose prompt ended earlier run with valid = 0 and write
        only the scratch page, or write back what they read on the fixed
        layout); returns each row's last-token hidden."""
        dev = self.device
        C = self.engine_config.prefill_chunk
        N, Tmax = tokens.shape
        last_h = torch.zeros(
            (N, self.model_config.hidden_size), dtype=self.params["embed"].dtype, device=dev
        )
        for k in range(-(-Tmax // C)):
            tok_k = np.zeros((N, C), np.int64)
            seg = tokens[:, k * C:(k + 1) * C]
            tok_k[:, : seg.shape[1]] = seg
            valid = torch.from_numpy(np.clip(lengths - k * C, 0, C)).to(dev)
            offsets = torch.full((N,), k * C, dtype=torch.long, device=dev)
            window = self._attention_window(min((k + 1) * C, self.max_seq_len))
            tok_d = torch.from_numpy(tok_k).to(dev)
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

    def _sample(self, logits: torch.Tensor, reqs: Sequence[_Request], key_positions) -> torch.Tensor:
        """One token per row of ``logits`` (rows aligned with ``reqs``),
        keyed by (seed, ``key_positions``) as the JAX engine keys it."""
        temps = torch.tensor([r.params.temperature for r in reqs], dtype=torch.float32)
        keys = None
        if bool((temps > 0).any()):
            seeds = torch.tensor([r.sampling_seed & 0x7FFFFFFF for r in reqs], dtype=torch.int64)
            keys = sampling.sample_keys(
                seeds.to(self.device), torch.tensor(key_positions, dtype=torch.int64).to(self.device)
            )
        topps = torch.tensor([r.params.top_p for r in reqs], dtype=torch.float32)
        return sampling.sample_tokens(
            logits[:, : self._sample_vocab], temps.to(self.device), topps.to(self.device), keys
        )

    def _decode_once(self) -> None:
        """One block of ``decode_block`` steps over every slot."""
        t0 = time.perf_counter()
        dev = self.device
        B = self.num_slots
        block = self._decode_block
        max_pos = self.max_seq_len - 1
        snapshot = sorted(self._slot_req.items())
        tokens = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int64)
        live = np.zeros(B, bool)
        temps = np.zeros(B, np.float32)
        topps = np.ones(B, np.float32)
        seeds = np.zeros(B, np.int64)
        for slot, req in snapshot:
            tokens[slot] = req.emitted[-1]
            positions[slot] = req.position
            live[slot] = True
            temps[slot] = req.params.temperature
            topps[slot] = req.params.top_p
            seeds[slot] = req.sampling_seed & 0x7FFFFFFF
        window = self._decode_window(int(positions.max()))
        keys = None
        if (temps > 0).any():
            # the token produced from input position p is keyed at p + 1;
            # the whole block's keys [block, B] in one device computation
            step_pos = np.minimum(positions[None, :] + np.arange(block)[:, None], max_pos)
            keys = sampling.sample_keys(
                torch.from_numpy(seeds).to(dev),
                torch.from_numpy(np.minimum(step_pos + 1, max_pos)).to(dev),
            )
        tok_d = torch.from_numpy(tokens).to(dev)
        pos_d = torch.from_numpy(positions).to(dev)
        live_d = torch.from_numpy(live).to(dev)
        temps_d = torch.from_numpy(temps).to(dev)
        topps_d = torch.from_numpy(topps).to(dev)
        token_slab = []
        for s in range(block):
            if self._paged:
                logits, _ = llama.decode_layers_paged(
                    self.params, self.model_config, tok_d, pos_d, live_d, self._tables,
                    self._cache, window=window, page_size=self._page,
                    quant_kernel=self._quant_kernel, page_kernel=self._page_kernel,
                )
            else:
                logits, _ = llama.decode_layers(
                    self.params, self.model_config, tok_d, pos_d, self._cache,
                    window=window, quant_kernel=self._quant_kernel, kv_kernel=self._kv_kernel,
                )
            tok_d = sampling.sample_tokens(
                logits[:, : self._sample_vocab], temps_d, topps_d,
                None if keys is None else (keys[0][s], keys[1][s]),
            )
            token_slab.append(tok_d)
            pos_d = torch.clamp(pos_d + 1, max=max_pos)
        slab_h = torch.stack(token_slab).cpu().numpy()  # the block's one sync
        self._counters["decode_blocks"] += 1
        self._counters["decode_steps"] += block
        self._counters["decode_rows"] += block * len(snapshot)
        self._counters["decode_time_s"] += time.perf_counter() - t0
        for row in slab_h:
            for slot, req in snapshot:
                if req.finished:
                    continue  # overran past this request's stop
                req.position += 1
                self._emit(req, int(row[slot]))
        self._release_finished()

    def _emit(self, req: _Request, token: int) -> None:
        req.generated += 1
        req.emitted.append(token)
        self._counters["tokens_generated"] += 1
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

    @staticmethod
    def _finish(req: _Request) -> None:
        if not req.finished:
            req.finished = True
            req.out_queue.put(_END)

    def _release_finished(self) -> None:
        for slot, req in list(self._slot_req.items()):
            if req.finished or req.cancelled:
                self._finish(req)
                self._release(slot)

    def _release(self, slot: int) -> None:
        """Free a slot and, on the paged layout, its pages; its table row
        points back at the scratch page."""
        req = self._slot_req.pop(slot, None)
        if req is None:
            return
        if self._paged:
            pages = self._slot_pages.pop(slot, None)
            if pages:
                self._kv_alloc.release(pages)
            self._tables[slot] = 0
        req.slot = -1
        self._free_slots.append(slot)


_ENGINE_LOCK = threading.Lock()
_ENGINE: Optional[LLMEngine] = None  # guarded by _ENGINE_LOCK


def get_engine(config: Optional[EngineConfig] = None) -> LLMEngine:
    """Process-wide engine singleton on the card (weights live once there);
    ``config=None`` reads the ``APP_ENGINE_*`` environment
    (``EngineConfig.from_env``)."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = LLMEngine(config or EngineConfig.from_env())
        return _ENGINE
