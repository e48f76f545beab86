"""Live-request checkpoint and restore: what a drained engine's requests
carry to another engine.

The port's copy of the JAX package's generativeaiexamples_tpu/engine/request_snapshot.py,
with its document format: a :class:`RequestSnapshot` holds a request's
emitted tokens, pinned sampling seed, decode position and sampling
parameters, plus the KV page payload read back from the paged pool. A
fresh engine restores it (``LLMEngine.restore_snapshot``) and resumes
the stream token for token: sampling keys derive from (seed, position),
so a continuation at position P samples what the drained engine would
have.

The payload has JAX's array shapes and dtypes per pool dtype, because
the port's pool has JAX's layout: per layer ``k``/``v`` of ``[pages,
page_size, Hkv, Dh]`` (bf16; int8; int4 as uint8 ``[..., Dh // 2]`` with
the split-halves nibble order) and, for the quantized pools, f32 scale
planes ``ks``/``vs`` of ``[pages, page_size, Hkv]``. Arrays travel as
base64 of their little-endian bytes under JAX's dtype names, so either
package decodes the other's documents bitwise; the port decodes to CPU
tensors (bf16 included: numpy has no bf16, torch has).

On a sharded engine each shard's pool holds ``Hkv / N`` of the heads: the
capture gathers every shard's rows of the snapshot's pages and
concatenates them in shard order on the head axis, so the payload and
``geometry.num_kv_heads`` are the full model's, as JAX's document is, and
the restore's write (:func:`write_pages`) splits them back over the
restoring engine's shards. A snapshot therefore restores at any shard
count, and into the JAX engine.

Snapshots spool to a bounded directory (oldest first out), each stamped
with the git revision that wrote it and the engine config's fingerprint
(utils/provenance.py);
restore refuses a fingerprint or a KV geometry that differs from the
engine's. The counters are JAX's families (``genai_engine_preempted_total``,
``_restored_total``, ``_restore_seconds``, ``_snapshot_bytes_total``);
``restore_latencies`` keeps each restore's latency as well.
"""
from __future__ import annotations

import base64
import collections
import dataclasses
import json
import logging
import os
import secrets
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.parallel import sharding
from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod
from generativeaiexamples_tpu_torch.utils import provenance

logger = logging.getLogger(__name__)

_REG = metrics_mod.get_registry()
_M_PREEMPTED = _REG.counter(
    "genai_engine_preempted_total",
    "Live requests checkpointed off a draining engine, by mode: "
    "mode='snapshot' (KV payload spooled — restorable mid-stream) vs "
    "mode='replay' (no KV to spool — prompt + pinned seed only, the "
    "sibling replays from the prompt).",
    ("mode",),
)
_M_RESTORED = _REG.counter(
    "genai_engine_restored_total",
    "Snapshots re-admitted on this engine, by mode: mode='restore' "
    "(KV payload uploaded, decode resumed at the spooled position) vs "
    "mode='replay' (no payload or no slot/pages — full re-prefill "
    "from the prompt with the pinned seed).",
    ("mode",),
)
_M_RESTORE_LATENCY = _REG.histogram(
    "genai_engine_restore_seconds",
    "Snapshot re-admission latency: restore_snapshot() entry to the "
    "request registered into the decode batch (KV upload included).",
)
_M_SNAPSHOT_BYTES = _REG.counter(
    "genai_engine_snapshot_bytes_total",
    "KV payload bytes captured into request snapshots (what a drain "
    "reads back from the paged pool and spools to disk).",
)


SNAPSHOT_VERSION = 1

# restore_snapshot entry to decode registration, seconds, per restore
restore_latencies: "collections.deque[float]" = collections.deque(maxlen=4096)


def record_preempted(mode: str) -> None:
    """Count one preempted live request (mode 'snapshot' | 'replay')."""
    _M_PREEMPTED.labels(mode=mode).inc()


def record_restored(mode: str, latency_s: Optional[float] = None) -> None:
    """Count one re-admission (mode 'restore' | 'replay')."""
    _M_RESTORED.labels(mode=mode).inc()
    if latency_s is not None:
        restore_latencies.append(latency_s)
        _M_RESTORE_LATENCY.observe(latency_s)


class SnapshotError(RuntimeError):
    """Base error for snapshot capture, spool and restore failures."""


class SnapshotMismatch(SnapshotError):
    """The snapshot's config fingerprint or KV geometry does not match
    the engine asked to restore it (HTTP 409)."""


# --------------------------------------------------------------------------- #
# Codec: tensors <-> JSON-safe documents

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _encode_array(arr) -> Dict[str, Any]:
    """A CPU tensor (or numpy array) as ``{"dtype", "shape", "data"}``."""
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    t = arr.detach().cpu().contiguous()
    raw = t.view(torch.uint8) if t.element_size() > 1 else t
    return {
        "dtype": _NAMES[t.dtype],
        "shape": list(t.shape),
        "data": base64.b64encode(raw.numpy().tobytes()).decode("ascii"),
    }


def _decode_array(doc: Dict[str, Any]) -> torch.Tensor:
    dtype = _DTYPES[doc["dtype"]]
    buf = bytearray(base64.b64decode(doc["data"]))
    flat = torch.frombuffer(buf, dtype=torch.uint8) if buf else torch.empty(0, dtype=torch.uint8)
    return flat.view(dtype).reshape(doc["shape"])


def encode_kv_payload(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-layer page gathers -> the JSON-safe payload document."""
    return {"layers": [{key: _encode_array(arr) for key, arr in layer.items()}
                       for layer in layers]}


def decode_kv_payload(doc: Dict[str, Any]) -> List[Dict[str, torch.Tensor]]:
    return [{key: _decode_array(arr) for key, arr in layer.items()} for layer in doc["layers"]]


def params_doc(params: Any) -> Dict[str, Any]:
    """SamplingParams as a plain dict, with JAX's keys; ``spec_decode``
    travels, so a restored request drafts (or opts out) as it did."""
    return {
        "temperature": params.temperature,
        "top_p": params.top_p,
        "max_tokens": params.max_tokens,
        "stop": list(params.stop),
        "seed": params.seed,
        "prefix_hint": params.prefix_hint,
        "spec_decode": getattr(params, "spec_decode", None),
    }


@dataclasses.dataclass
class RequestSnapshot:
    """One preempted request, portable between engines.

    ``position`` is the next decode position: KV rows [0, position) are
    live (the prompt and every emitted token but the last), and
    ``emitted[-1]`` is the next decode input. ``kv`` is the page payload
    over those rows, or None for a replay-only snapshot (never admitted,
    the fixed layout, or a missed park deadline)."""

    snapshot_id: str
    rid: int
    prompt_ids: List[int]
    emitted: List[int]
    position: int
    sampling_seed: int
    params: Dict[str, Any]
    geometry: Optional[Dict[str, Any]] = None
    kv: Optional[Dict[str, Any]] = None
    config_fingerprint: Optional[str] = None
    created_at: float = 0.0

    @property
    def restorable(self) -> bool:
        """Whether a KV payload travels with it (restore, not replay)."""
        return self.kv is not None

    def to_doc(self) -> Dict[str, Any]:
        return {
            "version": SNAPSHOT_VERSION,
            "snapshot_id": self.snapshot_id,
            "rid": self.rid,
            "prompt_ids": list(self.prompt_ids),
            "emitted": list(self.emitted),
            "position": self.position,
            "sampling_seed": self.sampling_seed,
            "params": dict(self.params),
            "geometry": dict(self.geometry) if self.geometry else None,
            "kv": self.kv,
            "config_fingerprint": self.config_fingerprint,
            "created_at": self.created_at,
            "provenance": {
                "git_sha": provenance.git_sha(),
                "git_dirty": provenance.git_dirty(),
            },
        }

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "RequestSnapshot":
        if doc.get("version") != SNAPSHOT_VERSION:
            raise SnapshotMismatch(
                f"snapshot version {doc.get('version')!r} is not "
                f"{SNAPSHOT_VERSION} — refusing to restore"
            )
        return cls(
            snapshot_id=doc["snapshot_id"],
            rid=int(doc["rid"]),
            prompt_ids=[int(t) for t in doc["prompt_ids"]],
            emitted=[int(t) for t in doc["emitted"]],
            position=int(doc["position"]),
            sampling_seed=int(doc["sampling_seed"]),
            params=dict(doc["params"]),
            geometry=doc.get("geometry"),
            kv=doc.get("kv"),
            config_fingerprint=doc.get("config_fingerprint"),
            created_at=float(doc.get("created_at") or 0.0),
        )

    def sampling_params(self):
        """SamplingParams with the seed pinned to the spooled effective
        seed: an unseeded request's draw must not be drawn again."""
        from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

        p = self.params
        return SamplingParams(
            temperature=float(p.get("temperature", 0.2)),
            top_p=float(p.get("top_p", 0.7)),
            max_tokens=int(p.get("max_tokens", 1024)),
            stop=tuple(p.get("stop") or ()),
            seed=self.sampling_seed,
            prefix_hint=p.get("prefix_hint"),
            spec_decode=p.get("spec_decode"),
        )


# --------------------------------------------------------------------------- #
# Engine-side capture


def engine_kv_dtype(engine) -> str:
    """Storage dtype of the engine's KV pool rows."""
    if not getattr(engine, "_kv_quant", False):
        return "bfloat16"
    return "int4" if getattr(engine, "_kv_packed", False) else "int8"


def _pieces(layer) -> list:
    """A layer's pool dicts: one a shard, or the layer itself."""
    return list(layer) if isinstance(layer, sharding.Shards) else [layer]


def read_pages(engine, pages) -> List[Dict[str, torch.Tensor]]:
    """The pool rows of ``pages`` from every layer as CPU tensors (a copy:
    shared prefix pages stay in the pool), every shard's heads
    concatenated in shard order. Waits for the device: the caller is the
    drain thread, with the dispatch loop parked."""
    idx = torch.tensor(list(pages), dtype=torch.long)
    specs = sharding.kv_pool_specs(engine._kv_quant)
    out = []
    for layer in engine._cache:
        pieces = _pieces(layer)
        out.append({key: torch.cat([p[key].index_select(0, idx.to(p[key].device)).cpu()
                                    for p in pieces], dim=specs[key])
                    for key in pieces[0]})
    return out


def write_pages(engine, pages, payload: List[Dict[str, torch.Tensor]]) -> None:
    """Scatter a decoded payload into ``pages`` of every layer's pool (the
    restore's write, on the dispatch thread, without waiting): each
    key's heads split over the engine's shards in shard order."""
    idx = engine._stage(torch.tensor(list(pages), dtype=torch.long))
    specs = sharding.kv_pool_specs(engine._kv_quant)
    for layer, upload in zip(engine._cache, payload):
        pieces = _pieces(layer)
        for key, arr in upload.items():
            for piece, part in zip(pieces, torch.chunk(arr, len(pieces), dim=specs[key])):
                buf = piece[key]
                buf.index_copy_(0, idx.to(buf.device), engine._stage(part).to(buf.device))


def capture(engine, req, position: int, pages: Tuple[int, ...]) -> RequestSnapshot:
    """A quiesced live request as a RequestSnapshot, its KV rows
    [0, position) read back page by page from the pool. Runs with the
    engine's dispatch loop parked and its prefill tier idle (the drain's
    contract)."""
    snap_id = f"snap-{req.rid}-{secrets.token_hex(6)}"
    emitted = list(getattr(req, "emitted", ()) or ())
    kv_doc = None
    geometry = None
    if getattr(engine, "_paged", False) and pages and position > 0:
        page = engine.engine_config.page_size
        n_payload = min((position + page - 1) // page, len(pages))
        host_layers = read_pages(engine, pages[:n_payload])
        nbytes = sum(t.numel() * t.element_size() for layer in host_layers for t in layer.values())
        _M_SNAPSHOT_BYTES.inc(nbytes)
        kv_doc = encode_kv_payload(host_layers)
        mc = engine.model_config
        geometry = {
            "page_size": page,
            "pages": int(n_payload),
            "quantized": bool(getattr(engine, "_kv_quant", False)),
            "kv_dtype": engine_kv_dtype(engine),
            "num_layers": mc.num_layers,
            "num_kv_heads": mc.num_kv_heads,
            "head_dim": mc.head_dim,
        }
    return RequestSnapshot(
        snapshot_id=snap_id,
        rid=req.rid,
        prompt_ids=list(req.prompt_ids),
        emitted=emitted,
        position=int(position),
        sampling_seed=int(req.sampling_seed),
        params=params_doc(req.params),
        geometry=geometry,
        kv=kv_doc,
        created_at=time.time(),
    )


def check_geometry(engine, snap: RequestSnapshot) -> None:
    """Refuse a KV payload whose pool geometry differs from the engine's."""
    if snap.kv is None:
        return
    geo = snap.geometry or {}
    mc = engine.model_config
    expect = {
        "page_size": engine.engine_config.page_size,
        "quantized": bool(getattr(engine, "_kv_quant", False)),
        "kv_dtype": engine_kv_dtype(engine),
        "num_layers": mc.num_layers,
        "num_kv_heads": mc.num_kv_heads,
        "head_dim": mc.head_dim,
    }
    for key, want in expect.items():
        got = geo.get(key)
        if key == "kv_dtype" and got is None and want != "int4":
            # a document from before kv_dtype: the quantized flag tells
            # bf16 from int8, and it cannot hold int4 bytes
            continue
        if got != want:
            raise SnapshotMismatch(
                f"snapshot {snap.snapshot_id} KV geometry mismatch: "
                f"{key} is {got!r}, engine wants {want!r}"
            )


# --------------------------------------------------------------------------- #
# The bounded on-disk spool


class SnapshotSpool:
    """One ``<snapshot_id>.json`` per preempted request, the oldest evicted
    past ``max_entries``; restore refuses a config-fingerprint mismatch."""

    def __init__(self, directory: str, max_entries: int = 64,
                 fingerprint: Optional[str] = None) -> None:
        self.directory = directory
        self.max_entries = max(1, int(max_entries))
        self.fingerprint = fingerprint

    def _path(self, snapshot_id: str) -> str:
        return os.path.join(self.directory, f"{os.path.basename(snapshot_id)}.json")

    def save(self, snap: RequestSnapshot) -> str:
        os.makedirs(self.directory, exist_ok=True)
        snap.config_fingerprint = self.fingerprint
        path = self._path(snap.snapshot_id)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap.to_doc(), fh)
        os.replace(tmp, path)
        self._evict_old()
        logger.info("spooled snapshot %s (rid %d, position %d, %s)", snap.snapshot_id, snap.rid,
                    snap.position, "kv payload" if snap.restorable else "replay-only")
        return path

    def load_doc(self, snapshot_id: str) -> Dict[str, Any]:
        """The raw document, relayed as it is to another engine's
        ``/internal/restore``."""
        try:
            with open(self._path(snapshot_id), "r", encoding="utf-8") as fh:
                return json.load(fh)
        except FileNotFoundError:
            raise SnapshotError(f"snapshot {snapshot_id!r} not in spool") from None
        except (OSError, ValueError) as exc:
            raise SnapshotError(f"snapshot {snapshot_id!r} unreadable: {exc}") from exc

    def check_fingerprint(self, snap: RequestSnapshot) -> None:
        """A snapshot captured under another engine config must not resume
        here."""
        if self.fingerprint is None or snap.config_fingerprint is None:
            return
        if snap.config_fingerprint != self.fingerprint:
            raise SnapshotMismatch(
                f"snapshot {snap.snapshot_id} was captured under config "
                f"fingerprint {snap.config_fingerprint} but this engine "
                f"runs {self.fingerprint} — refusing to restore"
            )

    def _names(self) -> List[str]:
        try:
            return [n for n in os.listdir(self.directory) if n.endswith(".json")]
        except OSError:
            return []

    def list(self) -> List[Dict[str, Any]]:
        """The spool's inventory, newest first."""
        out: List[Dict[str, Any]] = []
        for name in self._names():
            path = os.path.join(self.directory, name)
            try:
                with open(path, "r", encoding="utf-8") as fh:
                    doc = json.load(fh)
                out.append({
                    "snapshot_id": doc.get("snapshot_id"),
                    "rid": doc.get("rid"),
                    "position": doc.get("position"),
                    "emitted": len(doc.get("emitted") or ()),
                    "restorable": doc.get("kv") is not None,
                    "created_at": doc.get("created_at"),
                    "config_fingerprint": doc.get("config_fingerprint"),
                    "bytes": os.path.getsize(path),
                })
            except (OSError, ValueError):
                continue
        out.sort(key=lambda d: d.get("created_at") or 0.0, reverse=True)
        return out

    def _evict_old(self) -> None:
        names = self._names()
        if len(names) <= self.max_entries:
            return
        paths = sorted((os.path.join(self.directory, n) for n in names), key=os.path.getmtime)
        for path in paths[: len(paths) - self.max_entries]:
            try:
                os.remove(path)
                logger.warning("snapshot spool over %d entries — evicted %s",
                               self.max_entries, os.path.basename(path))
            except OSError:
                pass
