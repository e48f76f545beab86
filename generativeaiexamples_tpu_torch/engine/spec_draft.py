"""Resident draft-model runtime for speculative decoding.

Counterpart of generativeaiexamples_tpu/engine/spec_draft.py.
``spec_proposer='draft_model'`` (or ``'combined'``) builds a second,
small Llama next to the serving target, with its own dense weights and
its own fixed-layout KV cache (one ``max_seq_len`` strip per slot, bf16
or int8, whatever the target's layout), and drafts K tokens for the whole
decode wave in one batched dispatch a spec round
(models/llama.py ``draft_propose_layers``: a catch-up chunk feeding the
tokens the target emitted since each row's draft frontier, then K-1
greedy draft steps). The engine's verify then scores them, so a token
costs ``draft + verify / (accepted + 1)``.

On a sharded engine the draft lives on the engine's mesh, as JAX's does:
its weights cut by ``sharding.shard_params``, its strips by
``shard_draft_kv_cache`` (the target's rule: KV heads on the model axis),
and its proposals run shard by shard (``draft_propose_layers(tp=)``). A
draft whose heads, MLP width or vocab the shard count does not divide
stays whole on the mesh's first device, the same function on one device.

The per-slot frontier and its acceptance-rewind arithmetic live in
``spec_decode.DraftTracker``. The runtime's methods run on the engine's
dispatch thread, and under ``disagg`` admission's draft prefill runs on
the prefill tier, so one lock orders the two over the draft cache and
the tracker. The draft's weights come from the caller (``params``), else
from ``spec_draft_checkpoint_path`` (dense, ``hf_loader.load_params``),
else they are random (seed 0).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from generativeaiexamples_tpu_torch.engine import spec_decode as spec_decode_mod
from generativeaiexamples_tpu_torch.models import hf_loader, llama
from generativeaiexamples_tpu_torch.parallel import sharding, tp_kernels
from generativeaiexamples_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


def resolve_draft_config(cfg) -> llama.LlamaConfig:
    """The draft model's LlamaConfig: ``spec_draft_checkpoint_path``'s
    own config.json when present, else the ``spec_draft_model`` preset.
    Raises ValueError naming the knob on an unknown preset."""
    if getattr(cfg, "spec_draft_checkpoint_path", ""):
        model_cfg = hf_loader.config_from_hf(cfg.spec_draft_checkpoint_path)
        if model_cfg is not None:
            return model_cfg
    name = getattr(cfg, "spec_draft_model", "")
    if name not in llama.PRESETS:
        raise ValueError(
            f"spec_draft_model must name a models/llama.py preset "
            f"({', '.join(sorted(llama.PRESETS))}), got {name!r}"
        )
    return llama.PRESETS[name]


def attention_window(needed: int, max_seq_len: int) -> int:
    """The engine's power-of-two window rule (>= 128 rows)."""
    w = 128
    while w < needed and w < max_seq_len:
        w *= 2
    return min(w, max_seq_len)


class DraftRuntime:
    """The device half of the resident-draft proposer: the draft weights,
    its caches, admission's prefill (``prefill_wave``) and the per-round
    proposal (``propose``)."""

    def __init__(
        self,
        cfg,
        *,
        device: torch.device,
        dtype: torch.dtype,
        sample_vocab: int,
        num_slots: int,
        max_seq_len: int,
        params=None,
        mesh=None,
    ) -> None:
        self.device = device
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        dcfg = self.draft_config = resolve_draft_config(cfg)
        if dcfg.max_seq_len < max_seq_len:
            raise ValueError(
                f"spec_draft_model window ({dcfg.max_seq_len}) is "
                f"shorter than the serving capacity ({max_seq_len}); "
                f"the draft cache mirrors the target's positions, so "
                f"pick a draft config with max_seq_len >= the engine's"
            )
        # proposals must be ids the target can emit
        self._vocab = min(sample_vocab, dcfg.vocab_size)
        if dcfg.vocab_size < sample_vocab:
            logger.warning(
                "spec draft model vocab (%d) is smaller than the target's sampling "
                "vocab (%d); drafts are clamped to the shared prefix",
                dcfg.vocab_size, sample_vocab,
            )
        self._k = spec_decode_mod.effective_draft_len(cfg)
        self._c0 = self._k + 1  # catch-up width (DraftTracker invariant)
        self.tracker = spec_decode_mod.DraftTracker(self._k)
        self._chunk = min(cfg.prefill_chunk, max_seq_len)
        self._kv_quant = getattr(cfg, "spec_draft_kv_dtype", "bfloat16") == "int8"
        ckpt = getattr(cfg, "spec_draft_checkpoint_path", "")
        if params is None and ckpt:  # dense: a small model never needs packing
            params = hf_loader.load_params(ckpt, dcfg, dtype, device)
            logger.info("Loaded draft-model weights from %s", ckpt)
        elif params is None:
            params = llama.init_params(dcfg, 0, dtype, device)
            logger.warning("Resident draft model running with random-init weights "
                           "(no spec_draft_checkpoint_path).")
        caches = llama.init_kv_cache_layers(
            dcfg, num_slots, max_seq_len, dtype, device, quantized=self._kv_quant
        )
        self._tp: Optional[tp_kernels.TPContext] = None
        if mesh is not None and mesh.size > 1:
            if tp_kernels.supports_model_config(dcfg, mesh.size):
                self._tp = tp_kernels.TPContext(mesh, mesh.size,
                                                annotate=profiling.annotation_scope())
                params = sharding.shard_params(params, mesh)
                caches = sharding.shard_draft_kv_cache(caches, mesh)
            else:
                logger.warning(
                    "spec draft model (heads %d/%d, intermediate %d, vocab %d) does not divide "
                    "over %d shards: it runs whole on %s", dcfg.num_heads, dcfg.num_kv_heads,
                    dcfg.intermediate_size, dcfg.vocab_size, mesh.size, device,
                )
        self._params = params
        self._caches = caches
        self._lock = threading.Lock()
        self.last_dispatch_s = 0.0
        logger.info(
            "resident draft model: %d layers x %d hidden (target %d slots, K=%d, kv=%s, "
            "%d shards)", dcfg.num_layers, dcfg.hidden_size, num_slots, self._k,
            "int8" if self._kv_quant else "bf16", self.shards,
        )

    @property
    def shards(self) -> int:
        """Shards the draft runs on (1: whole on one device)."""
        return 1 if self._tp is None else self._tp.shards

    def cache_bytes(self) -> int:
        """Device bytes of the draft's caches, every shard's."""
        return sum(t.numel() * t.element_size() for c in self._caches
                   for piece in (c if isinstance(c, sharding.Shards) else [c])
                   for t in piece.values())

    # ------------------------------------------------------------------ #
    # slot lifecycle
    def on_admit(self, slot: int, prompt_len: int) -> None:
        with self._lock:
            self.tracker.on_admit(slot, prompt_len)

    def on_release(self, slot: int) -> None:
        with self._lock:
            self.tracker.on_release(slot)

    def reset(self) -> None:
        with self._lock:
            self.tracker.reset()

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int64))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------------ #
    def prefill_wave(
        self,
        tokens: np.ndarray,  # [N, bucket] the admission wave's prompts
        lengths: np.ndarray,  # [N]
        slots: Sequence[int],  # [N]
        eligible: np.ndarray,  # [N] bool: rows that will draft
    ) -> None:
        """Write the eligible rows' prompts into the draft cache, chunk by
        chunk (``extend_layers``). The draft has no prefix cache: a warm
        target row feeds its whole prompt here. The frontier
        (``on_admit``) is the caller's, after it seeds the context."""
        rows = [i for i in range(len(slots)) if eligible[i]]
        if not rows:
            return
        C = self._chunk
        n = len(rows)
        tok = tokens[rows]
        lens = np.asarray(lengths, np.int64)[rows]
        slot_d = self._to_device(np.asarray([slots[i] for i in rows]))
        with self._lock, torch.inference_mode():
            for k in range(-(-int(lens.max()) // C)):
                tok_k = np.zeros((n, C), np.int64)
                seg = tok[:, k * C:(k + 1) * C]
                tok_k[:, : seg.shape[1]] = seg
                valid = np.clip(lens - k * C, 0, C)
                W = attention_window(min((k + 1) * C, self.max_seq_len), self.max_seq_len)
                llama.extend_layers(
                    self._params, self.draft_config, self._to_device(tok_k),
                    self._to_device(np.full((n,), k * C)), self._to_device(valid), slot_d,
                    self._caches, W, quant_kernel=False, tp=self._tp,
                )
                spec_decode_mod.record_draft_dispatch(program="prefill")

    def propose(
        self, rows: Sequence[Tuple[int, Sequence[int], int]]
    ) -> Dict[int, List[int]]:
        """One spec round's batched draft dispatch. ``rows`` is ``[(slot,
        ctx, cap)]`` for every live eligible row; every row with draft
        state has its pending context fed (the catch-up) whether or not
        its cap lets it draft this round. Returns ``{slot: proposal}``
        within each row's cap. The proposal slab's read back is the
        draft-model counterpart of the lookup proposer's host scan (the
        verify's draft is assembled on the host)."""
        B, C0 = self.num_slots, self._c0
        chunk = np.zeros((B, C0), np.int64)
        offsets = np.zeros((B,), np.int64)
        valid = np.zeros((B,), np.int64)
        spans: Dict[int, Tuple[int, int]] = {}  # slot -> (cap, ctx_len)
        with self._lock, torch.inference_mode():
            for slot, ctx, cap in rows:
                span = self.tracker.begin_round(slot, len(ctx))
                if span is None:
                    continue
                fed, pending = span
                chunk[slot, :pending] = ctx[fed:]
                offsets[slot] = fed
                valid[slot] = pending
                spans[slot] = (cap, len(ctx))
            if not spans:
                return {}
            needed = int(max(offsets[s] + valid[s] for s in spans) + self._k + 1)
            W = attention_window(min(needed, self.max_seq_len), self.max_seq_len)
            t0 = time.time()
            out, _ = llama.draft_propose_layers(
                self._params, self.draft_config, self._to_device(chunk),
                self._to_device(offsets), self._to_device(valid), self._caches, W,
                draft_k=self._k, vocab=self._vocab, quant_kernel=False, tp=self._tp,
            )
            with spec_decode_mod.allowed_sync("spec"):
                out_np = out.cpu().numpy()
            spec_decode_mod.record_draft_dispatch()
            self.last_dispatch_s = time.time() - t0
            result: Dict[int, List[int]] = {}
            for slot, (cap, ctx_len) in spans.items():
                self.tracker.mark_fed(slot, ctx_len)
                k = max(0, min(cap, self._k))
                if k:
                    result[slot] = [int(t) for t in out_np[slot, :k]]
        return result
