"""Token sampling: greedy argmax, and temperature + nucleus (top-p) over
the top ``NUCLEUS_TOP_K`` logits.

Counterpart of generativeaiexamples_tpu/models/sampling.py. Greedy rows
(temperature <= 0) take ``argmax``, exactly as the JAX package does.
Sampled rows draw by Gumbel-argmax over the nucleus of the top 64 logits,
with noise that depends only on (request seed, position): a request's
sampled stream is reproducible across batch compositions and restarts.

The noise comes from a ``torch.Generator`` per (seed, position), drawn on
the host (64 floats a row) and moved to the logits' device, so a decode
block needs no device-to-host sync to sample. It is not the JAX package's
threefry stream, so seeded streams match the reference in distribution,
not token for token; and rows with top_p >= 1 also draw from the top 64
(the JAX package draws those from the full vocabulary).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

NUCLEUS_TOP_K = 64


_MASK64 = (1 << 64) - 1


def _key(seed: int, position: int) -> int:
    """One 32-bit generator seed from (seed, position): splitmix64 of the
    pair, folded to 32 bits (the CPU generator keeps only the low 32 bits
    of its seed, so the pair must be mixed before it is cut)."""
    z = (((int(seed) & 0x7FFFFFFF) << 32) | (int(position) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return (z ^ (z >> 32)) & 0xFFFFFFFF


def sample_noise(seeds: Sequence[int], positions: Sequence[int], device="cpu") -> torch.Tensor:
    """Uniform noise [B, NUCLEUS_TOP_K] keyed by (seed, position) per row."""
    rows = []
    for seed, pos in zip(seeds, positions):
        gen = torch.Generator().manual_seed(_key(seed, pos))
        rows.append(torch.rand(NUCLEUS_TOP_K, generator=gen))
    return torch.stack(rows).to(device)


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    noise: Optional[torch.Tensor] = None,  # [B, NUCLEUS_TOP_K] from sample_noise
) -> torch.Tensor:
    """Next tokens [B] (int64). temperature <= 0 selects greedy argmax;
    ``noise=None`` means every row is greedy. Nucleus filtering keeps the
    smallest prefix of the descending top-K whose softmax mass (over the
    whole vocabulary) reaches top_p; the top token is always kept."""
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        return greedy
    temperature = temperature.to(logits.device, torch.float32)
    top_p = top_p.to(logits.device, torch.float32)
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    K = min(NUCLEUS_TOP_K, scaled.shape[-1])
    top_vals, top_idx = torch.topk(scaled, K, dim=-1)  # descending
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    top_probs = torch.exp(top_vals - lse)
    mass_before = torch.cumsum(top_probs, dim=-1) - top_probs
    keep = mass_before < top_p[:, None]
    masked = torch.where(keep, top_vals, torch.full_like(top_vals, -float("inf")))
    gumbel = -torch.log(-torch.log(noise[:, :K].clamp_min(1e-20)))
    choice = torch.argmax(masked + gumbel, dim=-1)
    pick = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature > 0, pick, greedy)
