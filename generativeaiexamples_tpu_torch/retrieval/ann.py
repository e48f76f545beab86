"""Exact and IVF top-k search over a corpus that lives on the card.

Counterpart of generativeaiexamples_tpu/retrieval/ann.py: the corpus is
ONE padded ``[capacity, D]`` f32 matrix (capacity a power-of-two rung,
floored at 1024 rows, as in JAX), scored against a row-padded query batch
as one matmul and ``torch.topk``. On a mesh (``mesh=``, parallel/mesh.py)
the corpus rows, the ``valid`` mask and the IVF assignments are cut over
the ``model`` shards, one slice on each shard's device, as JAX's
``refresh`` shards them: each shard scores its slice and takes its partial
top-``min(k, per)``, and the merge on the first device
(``_merge_shard_topk``, JAX's) takes a second top-k over the ``shards x
part_k`` candidates, their indices offset by ``shard x per``; only ``[rows,
k]`` is read back. A capacity the shards do not divide falls back to one
shard with JAX's warning. A matmul's row is not bitwise
independent of the row count (one row and eight take different kernels),
so a batch padded to a rung of the row ladder scores a query in the last
bits as it likes; ``pad_rows`` pads every dispatch to ``max_batch`` rows
instead, so the retrieval tier's waves (engine/retrieval_tier.py) answer
a query the same whatever else shares its wave.

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
import logging
import threading
from typing import List, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine.batcher import row_bucket
from generativeaiexamples_tpu_torch.utils.device_io import to_device, to_host

logger = logging.getLogger(__name__)

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


def _merge_shard_topk(parts, k: int, per: int):
    """The merge of the shards' partial top-k lists: ``parts`` is each
    shard's (scores, indices) ``[rows, part_k]`` over its slice, in shard
    order; a second top-k over the ``shards x part_k`` candidates on the
    first shard's device, each index offset by ``shard x per`` (JAX's
    ``_merge_shard_topk``)."""
    home = parts[0][0].device
    scores = torch.cat([s.to(home) for s, _ in parts], dim=1)
    idx = torch.cat([(i + shard * per).to(home) for shard, (_, i) in enumerate(parts)], dim=1)
    top, pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return top, torch.gather(idx, 1, pos)


class _Corpus:
    """One resident corpus version (device tensors, immutable once built):
    ``parts`` holds each shard's (matrix, valid, assign) slice of ``per``
    rows on its device; the centroids live on the first device."""

    __slots__ = ("parts", "centroids", "rows", "capacity", "per")

    def __init__(self, parts, centroids, rows, capacity):
        self.parts, self.centroids = parts, centroids
        self.rows, self.capacity = rows, capacity
        self.per = capacity // len(parts)

    @property
    def shards(self) -> int:
        return len(self.parts)


class ANNSearchEngine:
    """Top-k over one padded corpus matrix on the card, cut over the
    ``model`` shards of ``mesh`` where one is given.

    Thread-safe: ``refresh`` swaps in a new corpus under the instance lock;
    a search takes the current one and reads it lock-free (a search racing
    a refresh reads a consistent older corpus, as in JAX). ``device=None``
    means the card (the mesh's first device under ``mesh``).
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
        mesh=None,
        seed: int = 0,
        device=None,
    ) -> None:
        from generativeaiexamples_tpu_torch.engine.llm_engine import resolve_device

        if mode not in ANN_MODES:
            raise ValueError(f"ann mode must be one of {ANN_MODES}, got {mode!r}")
        if mesh is not None and device is None:
            device = mesh.home
        self.device = resolve_device(device, "ANNSearchEngine")
        self._mesh = mesh
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

    def _shard_count(self, capacity: int) -> int:
        """The ``model`` shards the corpus is cut over: 1 without a mesh,
        and 1 with JAX's warning where they do not divide ``capacity``."""
        shards = self._mesh.tp if self._mesh is not None else 1
        if shards <= 1:
            return 1
        if capacity % shards:
            logger.warning(
                "ANN capacity %d not divisible by model-axis size %d; "
                "falling back to unsharded search", capacity, shards,
            )
            return 1
        return shards

    def refresh(self, matrix: np.ndarray, version) -> None:
        """(Re)load the corpus onto the device, padded to its capacity
        rung and cut over the shards (one slice on each shard's device); a
        no-op when ``version`` matches the resident corpus."""
        with self._lock:
            if version == self._version:
                return
            rows = int(matrix.shape[0])
            cap = capacity_rung(rows, floor=self._fixed_capacity or MIN_CAPACITY_ROWS)
            shards = self._shard_count(cap)
            devices = self._mesh.devices[:shards] if shards > 1 else [self.device]
            src = np.asarray(matrix, np.float32)
            assign_host = centroids = None
            if self._mode == "ivf":
                nlist = min(self._nlist, max(1, rows)) if rows else self._nlist
                centroids, assign_host = _kmeans(matrix.astype(np.float32), nlist, seed=self._seed)
            per = cap // shards
            parts = []
            with self._on_stream(), torch.inference_mode():
                # each shard's padded slice made on its device; only the
                # real rows cross from the host
                for i, dev in enumerate(devices):
                    lo, hi = i * per, min(rows, (i + 1) * per)
                    part = torch.zeros((per, self._dim), dtype=torch.float32, device=dev)
                    valid = torch.zeros((per,), dtype=torch.bool, device=dev)
                    assign = None
                    if assign_host is not None:
                        assign = torch.full((per,), nlist, dtype=torch.int32, device=dev)  # never probed
                    if hi > lo:
                        part[: hi - lo] = to_device(src[lo:hi], dev)
                        valid[: hi - lo] = True
                        if assign is not None:
                            assign[: hi - lo] = to_device(assign_host[lo:hi], dev)
                    parts.append((part, valid, assign))
                if centroids is not None:
                    centroids = to_device(centroids, self.device)
            self._corpus = _Corpus(parts, centroids, rows, cap)
            self._version = version

    def _topk(self, corpus: _Corpus, q: torch.Tensor, k: int, nprobe: int):
        """One dispatch: the masked scores of ``q`` [rows, D] against each
        shard's slice and their top ``k`` (values, indices) on the first
        device, merged across shards (:func:`_merge_shard_topk`)."""
        probe = None
        if self._mode == "ivf":
            probe = torch.topk(q @ corpus.centroids.T, nprobe, dim=1).indices  # [rows, nprobe]
        parts = []
        for matrix, valid, assign in corpus.parts:
            qi = q.to(matrix.device)
            scores = qi @ matrix.T  # [rows, per]
            keep = valid[None, :]
            if probe is not None:
                probe_i = probe.to(matrix.device)
                keep = keep & (assign[None, :, None] == probe_i[:, None, :]).any(dim=-1)
            scores = torch.where(keep, scores, float("-inf"))
            if corpus.shards == 1:
                return torch.topk(scores, k, dim=1)
            parts.append(torch.topk(scores, min(k, corpus.per), dim=1))
        return _merge_shard_topk(parts, k, corpus.per)

    def search(self, queries: np.ndarray, top_k: int,
               pad_rows: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the resident corpus for ``[R, D]`` queries. Returns
        (scores [R, k'], indices [R, k']) with k' = min(top_k, live rows);
        rows beyond ``max_batch`` chunk through the row ladder, or with
        ``pad_rows`` each dispatch has ``max_batch`` rows. The caller
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
                rung = self._max_batch if pad_rows else row_bucket(chunk.shape[0], self._max_batch)
                q = np.zeros((rung, self._dim), np.float32)
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
            "shards": corpus.shards if corpus is not None else 1,
            "max_batch": self._max_batch,
            "device": str(self.device),
        }

