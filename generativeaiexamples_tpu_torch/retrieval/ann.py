"""Exact and IVF top-k search over a corpus that lives on the card.

Counterpart of generativeaiexamples_tpu/retrieval/ann.py on one device
(the JAX engine's shard merge over a mesh is ROADMAP queue 1 item 9): the
corpus is ONE padded ``[capacity, D]`` f32 matrix (capacity a power-of-two
rung, floored at 1024 rows, as in JAX), scored against a row-padded query
batch as one matmul and ``torch.topk``.

- ``exact``: full-corpus scoring;
- ``ivf``: a seeded host-side k-means (``_kmeans``, the JAX package's
  numpy code, so its assignments are bitwise JAX's) assigns rows to
  ``nlist`` centroids at refresh; a query scores the centroids first and
  only rows in its top-``nprobe`` clusters compete (the others mask to
  -inf). ``nprobe >= nlist`` is exact.

Scores are f32 products summed in f32: nothing here turns on TF32. Ties:
``lax.top_k`` puts the lower index first, ``torch.topk`` on the card
promises no order among equal scores. Searches run on the engine's own
CUDA stream with pinned copies (``utils/device_io.py``), so their readback
never waits for decode work the LLM engine queued on the default stream. The rung functions are kept from
JAX (they fix the shapes both packages dispatch); the port compiles
nothing, so it has no warmup.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.batcher import row_bucket
from generativeaiexamples_tpu_torch.utils.device_io import to_device, to_host

ANN_MODES = ("exact", "ivf")

#: Smallest corpus capacity rung.
MIN_CAPACITY_ROWS = 1024

#: Largest k rung of ``k_ladder`` by default.
DEFAULT_MAX_WARM_K = 64

_KMEANS_ITERS = 4


def pow2_rung(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    rung = 1
    while rung < n:
        rung *= 2
    return rung


def capacity_rung(rows: int, floor: int = MIN_CAPACITY_ROWS) -> int:
    """Padded corpus-row capacity for a live row count."""
    return max(floor, pow2_rung(max(1, rows)))


def k_rung(k: int, capacity: int) -> int:
    """Top-k rung: a power of two, clamped to the capacity."""
    return min(capacity, pow2_rung(max(1, k)))


def k_ladder(capacity: int, max_k: int = DEFAULT_MAX_WARM_K) -> Tuple[int, ...]:
    """Pow2 k rungs up to min(capacity, max_k)."""
    out: List[int] = []
    rung = 1
    top = min(capacity, max(1, max_k))
    while rung <= top:
        out.append(rung)
        rung *= 2
    return tuple(out)


def _kmeans(matrix: np.ndarray, nlist: int, seed: int = 0):
    """Seeded Lloyd iterations on the (normalized) corpus, host numpy,
    refresh time only. Returns (centroids [nlist, D] normalized,
    assign [N] int32)."""
    rng = np.random.RandomState(seed)
    n = matrix.shape[0]
    if n <= nlist:
        assign = np.arange(n, dtype=np.int32)
        centroids = np.zeros((nlist, matrix.shape[1]), np.float32)
        centroids[:n] = matrix
        return centroids, assign
    centroids = matrix[rng.choice(n, size=nlist, replace=False)].copy()
    assign = np.zeros(n, np.int32)
    for _ in range(_KMEANS_ITERS):
        assign = np.argmax(matrix @ centroids.T, axis=1).astype(np.int32)
        for c in range(nlist):
            members = matrix[assign == c]
            if len(members):
                mean = members.mean(axis=0)
                norm = float(np.linalg.norm(mean))
                if norm > 0:
                    centroids[c] = mean / norm
    return centroids.astype(np.float32), assign


class _Corpus:
    """One resident corpus version (device tensors, immutable once built)."""

    __slots__ = ("matrix", "valid", "assign", "centroids", "rows", "capacity")

    def __init__(self, matrix, valid, assign, centroids, rows, capacity):
        self.matrix, self.valid, self.assign, self.centroids = matrix, valid, assign, centroids
        self.rows, self.capacity = rows, capacity


class ANNSearchEngine:
    """Top-k over one padded corpus matrix on the card.

    Thread-safe: ``refresh`` swaps in a new corpus under the instance lock;
    a search takes the current one and reads it lock-free (a search racing
    a refresh reads a consistent older corpus, as in JAX). ``device=None``
    means the card.
    """

    def __init__(
        self,
        dimensions: int,
        *,
        mode: str = "exact",
        capacity: int = 0,
        max_batch: int = 8,
        nlist: int = 64,
        nprobe: int = 16,
        seed: int = 0,
        device=None,
    ) -> None:
        from generativeaiexamples_tpu_torch.engine.llm_engine import resolve_device

        if mode not in ANN_MODES:
            raise ValueError(f"ann mode must be one of {ANN_MODES}, got {mode!r}")
        self.device = resolve_device(device, "ANNSearchEngine")
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._dim = int(dimensions)
        self._mode = mode
        self._fixed_capacity = int(capacity)
        self._max_batch = max(1, int(max_batch))
        self._nlist = max(1, int(nlist))
        self._nprobe = max(1, int(nprobe))
        self._seed = int(seed)
        self._lock = threading.Lock()
        self._corpus = None  # guarded by self._lock
        self._version: object = object()  # never equals a store version; guarded by self._lock

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def refresh(self, matrix: np.ndarray, version) -> None:
        """(Re)load the corpus onto the device, padded to its capacity
        rung; a no-op when ``version`` matches the resident corpus."""
        with self._lock:
            if version == self._version:
                return
            rows = int(matrix.shape[0])
            cap = capacity_rung(rows, floor=self._fixed_capacity or MIN_CAPACITY_ROWS)
            assign = centroids = None
            with self._on_stream(), torch.inference_mode():
                padded = torch.zeros((cap, self._dim), dtype=torch.float32, device=self.device)
                padded[:rows] = to_device(np.asarray(matrix, np.float32), self.device)
                valid = torch.zeros((cap,), dtype=torch.bool, device=self.device)
                valid[:rows] = True
                if self._mode == "ivf":
                    nlist = min(self._nlist, max(1, rows)) if rows else self._nlist
                    cents, assign_host = _kmeans(matrix.astype(np.float32), nlist, seed=self._seed)
                    assign_pad = np.full((cap,), nlist, np.int32)  # never probed
                    assign_pad[:rows] = assign_host
                    assign = to_device(assign_pad, self.device)
                    centroids = to_device(cents, self.device)
            self._corpus = _Corpus(padded, valid, assign, centroids, rows, cap)
            self._version = version

    def _topk(self, corpus: _Corpus, q: torch.Tensor, k: int, nprobe: int):
        """One dispatch: the masked scores of ``q`` [rows, D] against the
        corpus and their top ``k`` (values, indices), on the device."""
        scores = q @ corpus.matrix.T  # [rows, capacity]
        keep = corpus.valid[None, :]
        if self._mode == "ivf":
            probe = torch.topk(q @ corpus.centroids.T, nprobe, dim=1).indices  # [rows, nprobe]
            keep = keep & (corpus.assign[None, :, None] == probe[:, None, :]).any(dim=-1)
        scores = torch.where(keep, scores, float("-inf"))
        return torch.topk(scores, k, dim=1)

    def search(self, queries: np.ndarray, top_k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the resident corpus for ``[R, D]`` queries. Returns
        (scores [R, k'], indices [R, k']) with k' = min(top_k, live rows);
        rows beyond ``max_batch`` chunk through the row ladder. The caller
        normalizes the queries."""
        with self._lock:
            corpus = self._corpus
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self._dim:
            raise ValueError(f"expected [R, {self._dim}] queries, got {queries.shape}")
        n = queries.shape[0]
        rows = corpus.rows if corpus is not None else 0
        k_req = min(int(top_k), rows)
        if rows == 0 or k_req <= 0 or n == 0:
            return np.zeros((n, 0), np.float32), np.zeros((n, 0), np.int64)
        kr = k_rung(k_req, corpus.capacity)
        nprobe = min(self._nprobe, self._nlist, corpus.centroids.shape[0]) if self._mode == "ivf" else 0
        out_scores: List[np.ndarray] = []
        out_idx: List[np.ndarray] = []
        with self._on_stream(), torch.inference_mode():
            for start in range(0, n, self._max_batch):
                chunk = queries[start:start + self._max_batch]
                q = np.zeros((row_bucket(chunk.shape[0], self._max_batch), self._dim), np.float32)
                q[: chunk.shape[0]] = chunk
                scores, idx = self._topk(corpus, to_device(q, self.device), kr, nprobe)
                out_scores.append(to_host(scores[: chunk.shape[0], :k_req]))
                out_idx.append(to_host(idx[: chunk.shape[0], :k_req]))
        return np.concatenate(out_scores, axis=0), np.concatenate(out_idx, axis=0).astype(np.int64)

    def describe(self) -> dict:
        with self._lock:
            corpus = self._corpus
        return {
            "mode": self._mode,
            "rows": corpus.rows if corpus is not None else 0,
            "capacity": corpus.capacity if corpus is not None else 0,
            "shards": 1,
            "max_batch": self._max_batch,
            "device": str(self.device),
        }

