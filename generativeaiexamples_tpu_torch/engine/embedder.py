"""Embedding backends.

Counterpart of generativeaiexamples_tpu/engine/embedder.py:

- ``TorchEmbedder`` — the in-process BERT encoder (``models/bert.py``) on
  the card, the port's ``TPUEmbedder``: length-bucketed, row-padded
  dispatches through a shared ``MicroBatcher`` or synchronously;
- ``RemoteEmbedder`` — any OpenAI-compatible ``/v1/embeddings`` endpoint,
  over ``urllib``, retried with backoff behind the ``embedder`` circuit
  breaker as in JAX;
- ``HashEmbedder`` — deterministic feature hashing (no weights), bitwise
  the JAX package's.

``create_embedder`` dispatches on ``embeddings.model_engine`` with the JAX
package's names: ``tpu`` (the in-process encoder, on the card here),
``openai``/``nvidia-ai-endpoints``/``remote``, ``hash``.

There is no warmup ladder: nothing here compiles, so the JAX package's
``warmup_shapes`` and ``start_retrieval_warmup`` have no counterpart.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import json
import logging
import re
import threading
import time
import urllib.request
from collections import OrderedDict
from typing import List, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.batcher import LANE_INGEST, MicroBatcher, row_bucket
from generativeaiexamples_tpu_torch.utils import resilience
from generativeaiexamples_tpu_torch.utils.device_io import to_device, to_host

logger = logging.getLogger(__name__)

# arctic-embed models expect this query-side prefix (model card).
ARCTIC_QUERY_PREFIX = "Represent this sentence for searching relevant passages: "


def _decode_idle_gate():
    """Ingest-lane gate: ask the process LLM engine's scheduler policy for
    an ingest window (``UnifiedPolicy.ingest_window``: open when no decode
    slot is held) before a bulk embed dispatch. True when the window is
    open, or when no engine was built."""

    def gate(timeout_s: float) -> bool:
        from generativeaiexamples_tpu_torch.engine import llm_engine

        eng = llm_engine._ENGINE
        if eng is None:
            return True
        return eng.scheduler.ingest_window(timeout_s)

    return gate


class HashEmbedder:
    """Feature-hashed bag-of-words embeddings, L2-normalized: deterministic,
    no weights; cosine similarity reflects term overlap."""

    def __init__(self, dimensions: int = 1024):
        self.dimensions = dimensions

    def _embed_one(self, text: str) -> np.ndarray:
        vec = np.zeros(self.dimensions, np.float32)
        for token in re.findall(r"[a-z0-9]+", text.lower()):
            digest = hashlib.md5(token.encode()).digest()
            idx = int.from_bytes(digest[:4], "little") % self.dimensions
            sign = 1.0 if digest[4] & 1 else -1.0
            vec[idx] += sign
        norm = float(np.linalg.norm(vec))
        return vec / norm if norm > 0 else vec

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimensions), np.float32)
        return np.stack([self._embed_one(t) for t in texts])

    def embed_query(self, text: str) -> np.ndarray:
        return self._embed_one(text)


class _Encoder:
    """What the embedder and the reranker share: the device, the
    parameters, the tokenizer, the sequence buckets, one CUDA stream of
    their own and the counters.

    Each dispatch runs on the encoder's own stream with its copies staged
    through pinned memory (``utils/device_io.py``), so its readback (on the
    batcher thread or the calling thread) waits for its own work only,
    never for decode blocks the LLM engine queued on the default stream;
    kernels of both streams share the card's SMs."""

    BUCKETS = (32, 64, 128, 256, 512)

    def __init__(self, cfg, tokenizer, device):
        self._cfg = cfg
        self._tok = tokenizer
        self.device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._counters_lock = threading.Lock()
        # "device_dispatches" and, for the embedder, "query_cache_hits"
        self.counters: "collections.Counter[str]" = collections.Counter()

    def _params_ready(self) -> None:
        """The encoder's stream waits once for the work that made the
        parameters (on the default stream)."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    def _count(self, **deltas) -> None:
        with self._counters_lock:
            self.counters.update(deltas)

    def _bucket(self, n: int) -> int:
        limit = min(self._cfg.max_positions, self.BUCKETS[-1])
        for b in self.BUCKETS:
            if n <= b and b <= limit:
                return b
        return limit

    def _run(self, fn, *host_arrays) -> np.ndarray:
        """``fn`` over the host arrays copied to the device, on the
        encoder's stream; its result back on the host as numpy."""
        stream = torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()
        with torch.inference_mode(), stream:
            out = to_host(fn(*(to_device(a, self.device) for a in host_arrays)))
        self._count(device_dispatches=1)
        return out


def _checked_params(params, device):
    """Parameters handed in must already live on the encoder's device."""
    tensors = [t for k, t in params.items() if k != "layers"] + [
        t for lp in params["layers"] for t in lp.values()]
    wrong = {str(t.device) for t in tensors if t.device != device}
    if wrong:
        raise ValueError(f"parameters on {sorted(wrong)}, the encoder runs on {device}")
    return params


def _build_params(cfg, checkpoint_path, params, device, dtype, seed):
    from generativeaiexamples_tpu_torch.models import bert

    if checkpoint_path:
        return bert.load_bert_params(checkpoint_path, cfg, dtype)
    if params is not None:
        return _checked_params(params, device)
    logger.warning("BERT encoder running with random-init weights (seed %d, no checkpoint)", seed)
    return bert.init_bert_params(cfg, torch.Generator(device=device).manual_seed(seed), dtype, device)


def _preset(bert, model_name: str, default: str, tokenizer):
    preset = model_name if model_name in bert.BERT_PRESETS else default
    cfg = bert.BERT_PRESETS[preset]
    if getattr(tokenizer, "vocab_size", 0) > cfg.vocab_size:
        cfg = type(cfg)(**{**cfg.__dict__, "vocab_size": tokenizer.vocab_size})
    return cfg


class TorchEmbedder(_Encoder):
    """Batched, length-bucketed BERT embedding on the card (bf16).

    Two dispatch paths, as in JAX:

    - **batched** (``batching.enable=on``) — rows of every concurrent
      caller flow through one ``MicroBatcher`` (thread ``batcher-embed``)
      with two lanes: ``embed_query`` rows ride the query lane,
      ``embed_documents`` rows the ingest lane, which asks the LLM
      engine's scheduler for an ingest window before each batch;
    - **synchronous** (``batching.enable=off``) — each call dispatches its
      own batches, sleeping 10 ms between bulk batches while the engine
      decodes.

    Both pad rows up the ladder (``batcher.row_bucket``) and sequences to
    the bucket of the longest row. Whether a row's embedding depends on its
    batch-mates or its padding is the device's matter: on the CPU the two
    paths agree bit for bit (tests/test_torch_embedder.py); chip_smoke.py
    measures the card.

    ``device=None`` means the card (``llm_engine.resolve_device``);
    ``params`` (on that device) replaces the random weights drawn from
    ``seed``.
    """

    def __init__(
        self,
        checkpoint_path: str = "",
        model_name: str = "arctic-embed-l",
        tokenizer_path: str = "",
        max_batch: int = 32,
        query_prefix: str = ARCTIC_QUERY_PREFIX,
        batching=None,
        query_cache_size: int = 256,
        device=None,
        params=None,
        dtype=torch.bfloat16,
        seed: int = 0,
    ):
        from generativeaiexamples_tpu_torch.engine.llm_engine import resolve_device
        from generativeaiexamples_tpu_torch.engine.tokenizer import load_tokenizer
        from generativeaiexamples_tpu_torch.models import bert

        device = resolve_device(device, "TorchEmbedder")
        tok = load_tokenizer(tokenizer_path or checkpoint_path)
        cfg = _preset(bert, model_name, "arctic-embed-l", tok)
        super().__init__(cfg, tok, device)
        self.dimensions = cfg.hidden_size
        self.query_prefix = query_prefix
        self._max_batch = int(getattr(batching, "max_batch_embed", 0) or max_batch)
        self._params = _build_params(cfg, checkpoint_path, params, device, dtype, seed)
        self._params_ready()
        self._encode = lambda p, ids, mask: bert.bert_encode(p, cfg, ids, mask)
        self._query_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._query_cache_size = max(0, int(query_cache_size))
        self._query_cache_lock = threading.Lock()
        self._batching_on = getattr(batching, "enable", "off") == "on"
        yield_ms = float(getattr(batching, "ingest_decode_yield_ms", 50.0))
        self._batcher = MicroBatcher(
            "embed",
            self._dispatch_rows,
            max_batch=self._max_batch,
            max_wait_ms=float(getattr(batching, "max_wait_ms", 4.0)),
            ingest_gate=_decode_idle_gate() if yield_ms > 0 else None,
            gate_budget_ms=yield_ms,
        )

    def _tokenize(self, texts: Sequence[str]):
        return [self._tok.encode(t, add_bos=False)[: self._cfg.max_positions] for t in texts]

    @staticmethod
    def _decode_traffic_live() -> bool:
        """Whether the process LLM engine is decoding."""
        from generativeaiexamples_tpu_torch.engine import llm_engine

        eng = llm_engine._ENGINE
        return eng is not None and eng.is_decoding()

    def set_batching(self, on: bool) -> None:
        """Switch between the batched and synchronous dispatch paths."""
        self._batching_on = bool(on)

    def close(self) -> None:
        self._batcher.close()

    def clear_query_cache(self) -> None:
        with self._query_cache_lock:
            self._query_cache.clear()

    def _dispatch_rows(self, rows: Sequence[Sequence[int]], pad_rows: int) -> List[np.ndarray]:
        """ONE device dispatch for ``rows``, row-padded to ``pad_rows`` (a
        ladder rung) and sequence-padded to the bucket of the longest row.
        Returns one embedding per input row."""
        T = self._bucket(max(max((len(r) for r in rows), default=1), 1))
        ids_arr = np.zeros((pad_rows, T), np.int32)
        mask = np.zeros((pad_rows, T), np.int32)
        for row, ids in enumerate(rows):
            ids = list(ids[:T]) or [0]
            ids_arr[row, : len(ids)] = ids
            mask[row, : len(ids)] = 1
        emb = self._run(lambda i, m: self._encode(self._params, i, m), ids_arr, mask)
        return [emb[i] for i in range(len(rows))]

    def _embed_rows_sync(self, token_ids: List[Sequence[int]], out: np.ndarray,
                         order: Sequence[int]) -> None:
        """Synchronous path: this call's rows in length-sorted chunks."""
        for start in range(0, len(order), self._max_batch):
            # bulk embedding and live decode share the card: yield briefly
            # between batches while the engine decodes (the batched path
            # waits on the scheduler's ingest window instead)
            if start and self._decode_traffic_live():
                time.sleep(0.01)
            batch_idx = order[start : start + self._max_batch]
            batch_ids = token_ids[start : start + self._max_batch]
            emb = self._dispatch_rows(batch_ids, row_bucket(len(batch_ids), self._max_batch))
            for row, orig in enumerate(batch_idx):
                out[orig] = emb[row]

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimensions), np.float32)
        out = np.zeros((len(texts), self.dimensions), np.float32)
        order = sorted(range(len(texts)), key=lambda i: len(texts[i]))
        token_ids = self._tokenize([texts[i] for i in order])
        if self._batching_on:
            items = self._batcher.submit_many(token_ids, lane=LANE_INGEST)
            for row, orig in enumerate(order):
                out[orig] = items[row].get()
        else:
            self._embed_rows_sync(token_ids, out, order)
        return out

    def embed_query(self, text: str) -> np.ndarray:
        key = self.query_prefix + text
        if self._query_cache_size:
            with self._query_cache_lock:
                cached = self._query_cache.get(key)
                if cached is not None:
                    self._query_cache.move_to_end(key)
                    self._count(query_cache_hits=1)
                    return cached.copy()
        if self._batching_on:
            ids = self._tokenize([key])[0]
            vec = np.asarray(self._batcher.submit(ids).get(), np.float32)
        else:
            vec = self.embed_documents([key])[0]
        if self._query_cache_size:
            with self._query_cache_lock:
                self._query_cache[key] = np.array(vec, np.float32, copy=True)
                self._query_cache.move_to_end(key)
                while len(self._query_cache) > self._query_cache_size:
                    self._query_cache.popitem(last=False)
        return vec


def normalize_v1_url(server_url: str) -> str:
    """A model-server base URL ending in ``/v1``."""
    url = server_url.rstrip("/")
    if not url.endswith("/v1"):
        url += "/v1"
    return url


class RemoteEmbedder:
    """OpenAI-compatible ``/v1/embeddings`` client over ``urllib``."""

    def __init__(self, server_url: str, model_name: str, dimensions: int = 1024,
                 query_prefix: str = ARCTIC_QUERY_PREFIX, timeout: float = 120.0):
        self._url = normalize_v1_url(server_url)
        self._model = model_name
        self.dimensions = dimensions
        self.query_prefix = query_prefix
        self._timeout = timeout

    def embed_documents(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dimensions), np.float32)
        req = urllib.request.Request(
            f"{self._url}/embeddings",
            data=json.dumps({"model": self._model, "input": list(texts)}).encode(),
            headers={"Content-Type": "application/json"},
        )

        def post():
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                return json.loads(resp.read())

        # idempotent: retried with backoff behind the "embedder" breaker
        body = resilience.call_with_resilience(
            "embedder", post, retry_on=resilience.URL_ERRORS,
            retry_filter=resilience.http_error_is_transient,
        )
        data = sorted(body["data"], key=lambda d: d["index"])
        return np.asarray([d["embedding"] for d in data], np.float32)

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed_documents([self.query_prefix + text])[0]


_EMBEDDER_CACHE: dict = {}
# the factory's check-then-insert is atomic: two request threads never
# build two encoders (two copies of the weights on the card)
_EMBEDDER_CACHE_LOCK = threading.Lock()


def create_embedder(config=None, device=None):
    """The embedder ``config.embeddings`` names (``config=None`` reads the
    ``APP_*`` environment, ``config.AppConfig.from_env``), built once per
    (engine, server_url, model_name, device). The in-process encoder runs
    on the card unless ``device="cpu"``."""
    from generativeaiexamples_tpu_torch.config import AppConfig

    config = config or AppConfig.from_env()
    emb = config.embeddings
    key = (emb.model_engine, emb.server_url, emb.model_name, str(device))
    with _EMBEDDER_CACHE_LOCK:
        if key in _EMBEDDER_CACHE:
            return _EMBEDDER_CACHE[key]
        engine = (emb.model_engine or "tpu").lower()
        if engine in ("openai", "nvidia-ai-endpoints", "remote"):
            if not emb.server_url:
                raise ValueError(
                    f"embeddings.model_engine={engine!r} requires embeddings.server_url "
                    "(APP_EMBEDDINGS_SERVERURL); refusing to fall back to random-init weights"
                )
            backend = RemoteEmbedder(emb.server_url, emb.model_name, emb.dimensions)
        elif engine == "hash":
            backend = HashEmbedder(emb.dimensions)
        else:
            name = emb.model_name.split("/")[-1].replace("snowflake-", "")
            backend = TorchEmbedder(
                checkpoint_path=emb.checkpoint_path,
                model_name=name,
                tokenizer_path=config.engine.tokenizer_path,
                batching=config.batching,
                query_cache_size=emb.query_cache_size,
                device=device,
            )
        _EMBEDDER_CACHE[key] = backend
        return backend
