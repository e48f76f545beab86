"""Reranking backends for the ranked_hybrid retrieval pipeline.

Counterpart of generativeaiexamples_tpu/engine/reranker.py: the in-process
BERT cross-encoder on the card (``TorchReranker``, the port's
``TPUReranker``) and the lexical ``OverlapReranker`` for weights-free
tests. ``create_reranker`` takes the JAX package's engine names: '' (or
``none``/``disabled``) for no reranker, ``tpu`` for the in-process
cross-encoder, ``overlap``. The remote NIM ranking client is not ported
(it arrives with the chain-server wiring, ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import re
import threading
from typing import List, Sequence

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.batcher import MicroBatcher, row_bucket
from generativeaiexamples_tpu_torch.engine.embedder import _build_params, _Encoder, _preset


class OverlapReranker:
    """Deterministic lexical reranker (token Jaccard); no weights needed."""

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        q = set(re.findall(r"[a-z0-9]+", query.lower()))
        out = np.zeros(len(passages), np.float32)
        for i, passage in enumerate(passages):
            p = set(re.findall(r"[a-z0-9]+", passage.lower()))
            union = len(q | p)
            out[i] = len(q & p) / union if union else 0.0
        return out


class TorchReranker(_Encoder):
    """Batched BERT cross-encoder on the card: [CLS] query [SEP] passage
    [SEP], a linear head on the pooled CLS vector.

    Scoring runs through one ``MicroBatcher`` (thread ``batcher-rerank``,
    query lane only, no ingest gate) when ``batching.enable=on``, else
    inline; both paths pad rows up the ladder. ``device=None`` means the
    card; ``params`` and ``head`` (on that device) replace the random
    weights drawn from ``seed`` (encoder) and ``seed + 1`` (head).
    """

    BUCKETS = (64, 128, 256, 512)

    def __init__(
        self,
        checkpoint_path: str = "",
        model_name: str = "arctic-embed-m",
        tokenizer_path: str = "",
        max_batch: int = 16,
        batching=None,
        device=None,
        params=None,
        head=None,
        dtype=torch.bfloat16,
        seed: int = 0,
    ):
        from generativeaiexamples_tpu_torch.engine.llm_engine import resolve_device
        from generativeaiexamples_tpu_torch.engine.tokenizer import load_tokenizer
        from generativeaiexamples_tpu_torch.models import bert

        device = resolve_device(device, "TorchReranker")
        tok = load_tokenizer(tokenizer_path or checkpoint_path)
        cfg = _preset(bert, model_name, "arctic-embed-m", tok)
        super().__init__(cfg, tok, device)
        self._max_batch = int(getattr(batching, "max_batch_rerank", 0) or max_batch)
        self._params = _build_params(cfg, checkpoint_path, params, device, dtype, seed)
        # a plain BERT checkpoint has no rank head: random, as the LLM's
        self._head = head if head is not None else bert.init_rank_head(
            cfg, torch.Generator(device=device).manual_seed(seed + 1), dtype, device)
        self._params_ready()
        self._score = lambda p, h, ids, mask, types: bert.cross_encode_score(
            p, h, cfg, ids, mask, types)
        self._batching_on = getattr(batching, "enable", "off") == "on"
        self._batcher = MicroBatcher(
            "rerank",
            self._dispatch_pairs,
            max_batch=self._max_batch,
            max_wait_ms=float(getattr(batching, "max_wait_ms", 4.0)),
        )

    def set_batching(self, on: bool) -> None:
        """Switch between batched and synchronous scoring."""
        self._batching_on = bool(on)

    def close(self) -> None:
        self._batcher.close()

    def _dispatch_pairs(self, pairs: Sequence[tuple], pad_rows: int) -> List[np.float32]:
        """ONE device dispatch scoring ``pairs`` ((ids, types) tuples),
        row-padded to the ladder rung ``pad_rows``."""
        T = self._bucket(max(len(ids) for ids, _ in pairs))
        ids_arr = np.zeros((pad_rows, T), np.int32)
        mask = np.zeros((pad_rows, T), np.int32)
        type_arr = np.zeros((pad_rows, T), np.int32)
        for row, (ids, types) in enumerate(pairs):
            ids, types = ids[:T], types[:T]
            ids_arr[row, : len(ids)] = ids
            mask[row, : len(ids)] = 1
            type_arr[row, : len(types)] = types
        logits = self._run(lambda i, m, t: self._score(self._params, self._head, i, m, t),
                           ids_arr, mask, type_arr)
        return [logits[i] for i in range(len(pairs))]

    def _tokenize_pairs(self, query: str, passages: Sequence[str]) -> list:
        cls_id, sep_id = self._tok.cls_id, self._tok.sep_id
        q_ids = self._tok.encode(query, add_bos=False)[: self._cfg.max_positions // 2]
        pairs = []
        for passage in passages:
            p_ids = self._tok.encode(passage, add_bos=False)
            ids = [cls_id] + q_ids + [sep_id] + p_ids + [sep_id]
            types = [0] * (len(q_ids) + 2) + [1] * (len(p_ids) + 1)
            pairs.append((ids[: self._cfg.max_positions], types[: self._cfg.max_positions]))
        return pairs

    def score(self, query: str, passages: Sequence[str]) -> np.ndarray:
        if not passages:
            return np.zeros(0, np.float32)
        pairs = self._tokenize_pairs(query, passages)
        out = np.zeros(len(pairs), np.float32)
        order = sorted(range(len(pairs)), key=lambda i: len(pairs[i][0]))
        if self._batching_on:
            items = self._batcher.submit_many([pairs[i] for i in order])
            for row, i in enumerate(order):
                out[i] = items[row].get()
            return out
        for start in range(0, len(order), self._max_batch):
            batch_idx = order[start : start + self._max_batch]
            logits = self._dispatch_pairs(
                [pairs[i] for i in batch_idx], row_bucket(len(batch_idx), self._max_batch))
            for row, i in enumerate(batch_idx):
                out[i] = logits[row]
        return out


_RERANKER_CACHE: dict = {}
_RERANKER_CACHE_LOCK = threading.Lock()


def create_reranker(config=None, device=None):
    """The reranker ``config.ranking`` names, or None when reranking is
    disabled; built once per (engine, server_url, model_name, device)."""
    from generativeaiexamples_tpu_torch.config import AppConfig

    config = config or AppConfig.from_env()
    ranking = config.ranking
    engine = (ranking.model_engine or "").lower()
    if not engine or engine in ("none", "disabled"):
        return None
    key = (engine, ranking.server_url, ranking.model_name, str(device))
    with _RERANKER_CACHE_LOCK:
        if key in _RERANKER_CACHE:
            return _RERANKER_CACHE[key]
        if engine in ("remote", "nvidia-ai-endpoints", "openai"):
            raise ValueError(
                f"ranking.model_engine={engine!r}: the remote ranking client arrives with "
                "the chain-server wiring (ROADMAP queue 1 item 7)"
            )
        if engine == "overlap":
            backend = OverlapReranker()
        else:
            backend = TorchReranker(
                checkpoint_path=ranking.checkpoint_path,
                model_name=ranking.model_name.split("/")[-1],
                tokenizer_path=config.engine.tokenizer_path,
                batching=config.batching,
                device=device,
            )
        _RERANKER_CACHE[key] = backend
        return backend
