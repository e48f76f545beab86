"""Llama-family decoder for the serving path, in PyTorch.

Counterpart of generativeaiexamples_tpu/models/llama.py, for the layered
paged serving path: ``prefill_layers`` + ``write_prefill_pages`` for
monolithic prefill waves, ``extend_layers_paged`` for chunked prefill,
and ``decode_layers_paged`` for decode steps. Parameters are plain
dictionaries of tensors, one dict per layer (the JAX package's layered
layout, ``consume_split_params_layers``); projections are dense
``[K, F]`` matrices or int8 packs ``{"q", "scale"}`` (ops/quant.py).

Differences from the JAX functions, all in PyTorch idiom:
- the KV page pool is updated IN PLACE (``index_put_``): the pool dicts a
  caller passes are the pools returned, with no copy;
- the kernels are chosen by the same flags (``use_flash``,
  ``quant_kernel``, ``page_kernel``); a flag that selects a kernel runs
  it on CUDA tensors and its plain version on CPU tensors;
- random weights come from a seeded ``torch.Generator`` on the target
  device.

Physical page 0 of the pool is the scratch page: dead rows and padding
writes land there, never on a page a live request owns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from generativeaiexamples_tpu_torch.ops import flash_attention, int8_matmul, page_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture hyperparameters (Llama-3 defaults)."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    tie_embeddings: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


# Named presets, copied from the JAX package (tests/test_torch_llama.py
# pins them equal); selected via EngineConfig.model_config_name. The
# tiny ones serve tests: "debug" for the CPU parity tests,
# "kernel-8dev" for the head_dim-128 geometry the kernels accept.
PRESETS: Dict[str, LlamaConfig] = {
    "llama3-8b": LlamaConfig(),
    "llama3-70b": LlamaConfig(
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
    ),
    "llama3-1b-proxy": LlamaConfig(
        hidden_size=2048,
        intermediate_size=5504,
        num_layers=16,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
    ),
    "llama3-70b-tiny": LlamaConfig(
        vocab_size=512,
        hidden_size=256,
        intermediate_size=512,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=4,
        max_seq_len=128,
    ),
    "debug": LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=128,
    ),
    "debug-1k": LlamaConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=1024,
    ),
    "debug-draft": LlamaConfig(
        vocab_size=512,
        hidden_size=32,
        intermediate_size=64,
        num_layers=1,
        num_heads=2,
        num_kv_heads=1,
        head_dim=16,
        max_seq_len=128,
    ),
    "debug-8dev": LlamaConfig(
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_layers=2,
        num_heads=8,
        num_kv_heads=8,
        head_dim=16,
        max_seq_len=128,
    ),
    "llama3-70b-shard8": LlamaConfig(
        vocab_size=16032,
        hidden_size=8192,
        intermediate_size=3584,
        num_layers=80,
        num_heads=8,
        num_kv_heads=1,
        head_dim=128,
        max_seq_len=8192,
    ),
    "kernel-8dev": LlamaConfig(
        vocab_size=512,
        hidden_size=256,
        intermediate_size=512,
        num_layers=2,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        max_seq_len=256,
    ),
}


def init_spec(cfg: LlamaConfig) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Weight name -> (shape, std) for random init, stacked on a leading
    layer axis as in the JAX package (one source for every initializer).
    Norm weights (ones) are not listed."""
    h, q, kv, f, L = cfg.hidden_size, cfg.q_dim, cfg.kv_dim, cfg.intermediate_size, cfg.num_layers
    inv_h = 1.0 / math.sqrt(h)
    spec = {
        "embed": ((cfg.vocab_size, h), inv_h),
        "wq": ((L, h, q), inv_h),
        "wk": ((L, h, kv), inv_h),
        "wv": ((L, h, kv), inv_h),
        "wo": ((L, q, h), 1.0 / math.sqrt(q) / math.sqrt(2 * L)),
        "w_gate": ((L, h, f), inv_h),
        "w_up": ((L, h, f), inv_h),
        "w_down": ((L, f, h), 1.0 / math.sqrt(f) / math.sqrt(2 * L)),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ((h, cfg.vocab_size), inv_h)
    return spec


def count_logical_params(cfg: LlamaConfig) -> int:
    """Parameter count from the architecture alone (int8 packs pad K and
    F, so counting storage would over-count)."""
    n = sum(math.prod(shape) for shape, _ in init_spec(cfg).values())
    return n + cfg.num_layers * 2 * cfg.hidden_size + cfg.hidden_size


_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_params(
    cfg: LlamaConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16, device="cpu"
) -> Params:
    """Scaled-normal random weights drawn on ``device`` from a seeded
    generator, one dict per layer."""
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = init_spec(cfg)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * std).to(dtype)

    h = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        lp = {"attn_norm": torch.ones(h, dtype=dtype, device=device),
              "mlp_norm": torch.ones(h, dtype=dtype, device=device)}
        for name in _LAYER_WEIGHTS:
            shape, std = spec[name]
            lp[name] = normal(shape[1:], std)
        layers.append(lp)
    params: Params = {
        "embed": normal(*spec["embed"]),
        "layers": layers,
        "final_norm": torch.ones(h, dtype=dtype, device=device),
    }
    if "lm_head" in spec:
        params["lm_head"] = normal(*spec["lm_head"])
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Rotary embedding. x: [B, T, H, Dh], positions: [B, T] int."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].float() * freqs  # [B, T, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _attention(
    q: torch.Tensor,  # [B, T, Hq, Dh]
    k: torch.Tensor,  # [B, S, Hkv, Dh]
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    mask: torch.Tensor,  # [B, T, S] bool, True = attend
) -> torch.Tensor:
    """Grouped-query attention: f32 scores and softmax, probabilities
    rounded to v's dtype, f32 sum of the P.V product, one rounding."""
    B, T, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) / math.sqrt(Dh)
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float()).to(v.dtype)
    return out.reshape(B, T, Hq, Dh)


def _proj(x: torch.Tensor, w, quant_kernel: Optional[bool] = None) -> torch.Tensor:
    """x @ w for a dense [K, F] matrix or an int8 pack (ops/quant.py).
    ``quant_kernel=False`` takes the int8 kernel's plain version at decode
    shapes instead of the kernel."""
    if isinstance(w, dict):
        return int8_matmul.packed_matmul(x, w, use_kernel=quant_kernel is not False)
    return x @ w


def _block(h, lp, cfg: LlamaConfig, positions, attn, quant_kernel=None):
    """One transformer block; ``attn(q, k, v) -> out`` supplies the
    attention flavor (einsum, flash kernel, or a paged read)."""
    B, T = h.shape[:2]
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    if "wqkv" in lp:  # int8-fused serving layout (ops/quant.py)
        qkv = _proj(x, lp["wqkv"], quant_kernel)
        q, k, v = torch.split(qkv, [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q = _proj(x, lp["wq"], quant_kernel)
        k = _proj(x, lp["wk"], quant_kernel)
        v = _proj(x, lp["wv"], quant_kernel)
    q = apply_rope(q.reshape(B, T, cfg.num_heads, cfg.head_dim), positions, cfg)
    k = apply_rope(k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim), positions, cfg)
    v = v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    attn_out = attn(q, k, v)
    h = h + _proj(attn_out.reshape(B, T, cfg.q_dim), lp["wo"], quant_kernel)
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if "w_gateup" in lp:
        gate_raw, up = torch.split(
            _proj(x, lp["w_gateup"], quant_kernel), cfg.intermediate_size, dim=-1
        )
    else:
        gate_raw = _proj(x, lp["w_gate"], quant_kernel)
        up = _proj(x, lp["w_up"], quant_kernel)
    gate = torch.nn.functional.silu(gate_raw.float()).to(x.dtype)
    return h + _proj(gate * up, lp["w_down"], quant_kernel)


def _head(params: Params, h: torch.Tensor, cfg: LlamaConfig, quant_kernel=None) -> torch.Tensor:
    """Final RMSNorm + (possibly tied) lm head; f32 logits."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return _proj(h, head, quant_kernel).float()


def prefill_layers(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] right-padded prompts
    lengths: torch.Tensor,  # [B]
    use_flash: Optional[bool] = None,
    quant_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Unrolled prefill; returns (last-token logits [B, V], per-layer
    (k, v) [B, T, Hkv, Dh] for the caller to write into the page pool).
    ``use_flash=None`` follows ``flash_attention.preferred``."""
    B, T = tokens.shape
    device = tokens.device
    positions = torch.arange(T, device=device).expand(B, T)
    if use_flash is None:
        use_flash = flash_attention.preferred(T, cfg.head_dim, device)
    h = params["embed"][tokens]
    mask = None if use_flash else positions[:, :, None] >= positions[:, None, :]
    kvs = []

    def attn(q, k, v):
        kvs.append((k, v))
        if use_flash:
            return flash_attention.flash_attention_causal(q, k, v)
        return _attention(q, k, v, mask)

    for lp in params["layers"]:
        h = _block(h, lp, cfg, positions, attn, quant_kernel)
    last_h = h[torch.arange(B, device=device), lengths.long() - 1][:, None]
    return _head(params, last_h, cfg, quant_kernel)[:, 0, :], kvs


def init_kv_pool(
    cfg: LlamaConfig, pool: int, page_size: int, dtype: torch.dtype = torch.bfloat16,
    device="cpu",
) -> List[Dict[str, torch.Tensor]]:
    """Per-layer page pools ``[pool, page_size, Hkv, Dh]``, token-major."""
    shape = (pool, page_size, cfg.num_kv_heads, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers)
    ]


def _gather_page_window(
    buf: torch.Tensor, tables: torch.Tensor, pages_w: int, page_size: int
) -> torch.Tensor:
    """Each row's first ``pages_w`` pages as token rows: buf [P, page, ...]
    x tables [N, Pmax] -> [N, pages_w * page, ...]. Unused table entries
    point at the scratch page; callers mask their rows by position."""
    g = buf[tables[:, :pages_w].long()]
    return g.reshape((g.shape[0], pages_w * page_size) + tuple(buf.shape[2:]))


def write_prefill_pages(
    caches: list,
    kvs: list,  # per-layer (k, v) [N, T, Hkv, Dh] from prefill_layers
    row_tables: torch.Tensor,  # [N, Pmax] the wave rows' page tables
    page_size: int,
) -> list:
    """Scatter a monolithic wave's fresh K/V rows into the page pool, in
    place. Right-padding rows land in the rows' own reserved pages (decode
    overwrites them before any query attends them) or, past the
    reservation, on the scratch page."""
    N, T = kvs[0][0].shape[:2]
    pos = torch.arange(T, device=row_tables.device)
    phys = torch.gather(row_tables.long(), 1, (pos // page_size).expand(N, T))
    sip = (pos % page_size).expand(N, T)
    for c, (k, v) in zip(caches, kvs):
        c["k"].index_put_((phys, sip), k.to(c["k"].dtype))  # in place
        c["v"].index_put_((phys, sip), v.to(c["v"].dtype))
    return caches


def _chunk_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [N, C]
    offsets: torch.Tensor,  # [N]
    valid: torch.Tensor,  # [N]
    slots: torch.Tensor,  # [N] page-table row per chunk row
    tables: torch.Tensor,  # [B, Pmax] page tables of all slots
    caches: list,
    window: int,
    page_size: int,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, list]:
    """A chunk of up to C tokens per row at each row's offset: rows write
    their valid tokens into their pages (in place; dead rows write the
    scratch page) and attend the gathered window of ``window`` tokens, or,
    with ``page_kernel``, read the pool through the paged-attention
    kernel."""
    N, C = tokens.shape
    device = tokens.device
    Pmax = tables.shape[1]
    S = Pmax * page_size
    W = min(window, S)
    Pw = W // page_size
    ar = torch.arange(C, device=device)
    positions = torch.clamp(offsets.long()[:, None] + ar[None, :], max=S - 1)
    tok_valid = ar[None, :] < valid.long()[:, None]
    h = params["embed"][tokens]
    mask = torch.arange(W, device=device)[None, None, :] <= positions[:, :, None]
    row_tables = tables[slots.long()]
    phys = torch.gather(row_tables.long(), 1, positions // page_size)
    phys = torch.where((valid > 0)[:, None], phys, torch.zeros_like(phys))
    sip = positions % page_size

    for lp, c in zip(params["layers"], caches):
        def attn(q, k, v, c=c):
            cur_k = c["k"][phys, sip]
            cur_v = c["v"][phys, sip]
            row_k = torch.where(tok_valid[..., None, None], k.to(cur_k.dtype), cur_k)
            row_v = torch.where(tok_valid[..., None, None], v.to(cur_v.dtype), cur_v)
            c["k"].index_put_((phys, sip), row_k)  # in place
            c["v"].index_put_((phys, sip), row_v)
            if page_kernel:
                return page_attention.paged_attention(
                    q, c["k"], c["v"], row_tables, offsets
                ).to(q.dtype)
            return _attention(
                q,
                _gather_page_window(c["k"], row_tables, Pw, page_size),
                _gather_page_window(c["v"], row_tables, Pw, page_size),
                mask,
            )

        h = _block(h, lp, cfg, positions, attn, quant_kernel)
    return h, caches


def extend_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,
    offsets: torch.Tensor,
    valid: torch.Tensor,
    slots: torch.Tensor,
    tables: torch.Tensor,
    caches: list,
    window: int,
    page_size: int,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, list]:
    """Chunked prefill over the page pool; returns (each row's hidden state
    at its last valid token [N, D], pools). The engine leaves
    ``page_kernel`` unset here, as the JAX engine does: prefill-chunk
    widths exceed the kernel's query-row cap."""
    C = tokens.shape[1]
    h, caches = _chunk_layers_paged(
        params, cfg, tokens, offsets, valid, slots, tables, caches, window,
        page_size, quant_kernel=quant_kernel, page_kernel=page_kernel,
    )
    last_idx = torch.clamp(valid.long(), 1, C) - 1
    return h[torch.arange(h.shape[0], device=h.device), last_idx], caches


def decode_layers_paged(
    params: Params,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] (dead slots pre-zeroed by the engine)
    live: torch.Tensor,  # [B] bool
    tables: torch.Tensor,  # [B, Pmax]
    caches: list,
    window: Optional[int] = None,
    page_size: int = 128,
    quant_kernel: Optional[bool] = None,
    page_kernel: Optional[bool] = None,
) -> Tuple[torch.Tensor, list]:
    """One decode step over the page pool; returns (logits [B, V], pools).
    Each row writes its new K/V row in place (dead rows write the scratch
    page), then reads the pool through the paged-attention kernel
    (``page_kernel``) or the gathered window of ``window`` tokens."""
    device = tokens.device
    Pmax = tables.shape[1]
    S = Pmax * page_size
    W = min(window or S, S)
    Pw = W // page_size
    h = params["embed"][tokens[:, None]]
    pos2 = positions.long()[:, None]  # [B, 1]
    phys = torch.gather(tables.long(), 1, pos2 // page_size)
    phys = torch.where(live[:, None], phys, torch.zeros_like(phys))
    sip = pos2 % page_size
    mask = torch.arange(W, device=device)[None, None, :] <= pos2[:, :, None]

    for lp, c in zip(params["layers"], caches):
        def attn(q, k, v, c=c):
            c["k"].index_put_((phys, sip), k.to(c["k"].dtype))  # in place
            c["v"].index_put_((phys, sip), v.to(c["v"].dtype))
            if page_kernel:
                return page_attention.paged_attention(
                    q, c["k"], c["v"], tables, positions
                ).to(q.dtype)
            return _attention(
                q,
                _gather_page_window(c["k"], tables, Pw, page_size),
                _gather_page_window(c["v"], tables, Pw, page_size),
                mask,
            )

        h = _block(h, lp, cfg, pos2, attn, quant_kernel)
    return _head(params, h, cfg, quant_kernel)[:, 0, :], caches
