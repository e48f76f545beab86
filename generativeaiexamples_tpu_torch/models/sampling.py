"""Token sampling: greedy argmax, temperature sampling over the full
vocabulary, and nucleus (top-p) over the top ``NUCLEUS_TOP_K`` logits.

Counterpart of generativeaiexamples_tpu/models/sampling.py, token for
token. The random bits are JAX's: each row's key is
``fold_in(fold_in(PRNGKey(1234), seed), position)`` and a draw is
``argmax(gumbel(key, shape) + logits)`` with JAX's partitionable threefry
bits (``jax_threefry_partitionable``, the default) and its low-resolution
gumbel, ``-log(-log(uniform(tiny, 1)))``. Threefry-2x32 is integer
arithmetic on uint32 words; here the words live in int64 tensors and every
sum is masked back to 32 bits, so the keys and bits are bitwise JAX's on
any device. A request's sampled stream depends only on (seed, position):
it is the same across batch compositions, restarts and the two packages.

Everything runs as tensor ops on the logits' device: a decode block needs
no host noise and no device-to-host copy to sample.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NUCLEUS_TOP_K = 64
# jax.random.PRNGKey(1234): the (high, low) words of the 64-bit seed
BASE_KEY = (0, 1234)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[torch.Tensor, torch.Tensor]  # (k0, k1) uint32 words in int64 tensors


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1) -> Key:
    """JAX's threefry-2x32 hash (20 rounds) of the counter pair (x0, x1)
    under key (k0, k1); uint32 words in int64 tensors, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """``jax.random.fold_in``: the key hashed with the counter (0, data)."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data & _M32)


def sample_keys(seeds: torch.Tensor, positions: torch.Tensor) -> Key:
    """Per-row keys ``fold_in(fold_in(PRNGKey(1234), seed), position)``
    (``generativeaiexamples_tpu.models.sampling.sample_keys``), computed on
    the tensors' device; ``seeds`` and ``positions`` broadcast."""
    seeds, positions = torch.broadcast_tensors(seeds.long(), positions.long())
    base = tuple(torch.full_like(seeds, w) for w in BASE_KEY)
    return fold_in(fold_in(base, seeds), positions)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32-bit random words ``[..., n]`` of ``jax.random.bits(key, (n,))``
    per key: the partitionable scheme hashes counter (0, i) and XORs the
    two output words."""
    k0, k1 = key[0][..., None], key[1][..., None]
    counter = torch.arange(n, dtype=torch.int64, device=k0.device)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(counter), counter)
    return x0 ^ x1


def gumbel(key: Key, n: int) -> torch.Tensor:
    """f32 ``jax.random.gumbel(key, (n,))`` per key (mode "low"): the
    bits' top 23 as the mantissa of a float in [1, 2), minus 1, mapped
    onto [tiny, 1), then -log(-log(u))."""
    mant = (random_bits(key, n) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # filled on the device: torch.tensor(x, device=...) is a copy from the
    # host, which waits for the device
    tiny = torch.full((), torch.finfo(torch.float32).tiny, dtype=torch.float32, device=floats.device)
    one = torch.ones((), dtype=torch.float32, device=floats.device)
    u = torch.maximum(tiny, floats * (one - tiny) + tiny)
    return -torch.log(-torch.log(u))


def nucleus_top_k(scaled: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K largest values of each row and their indices, descending, with
    ``jax.lax.top_k``'s order among equal values: the lower index first.
    Packed weights give exact ties in the logits (w8a8's integer sums
    times shared scales), and ``torch.topk`` orders tied values as it
    likes; the nucleus draw indexes its gumbels by rank, so a tie ranked
    the other way draws another token. One top-k over an int64 key keeps
    the order without sorting the row: the f32 value's bits made monotone
    (a negative value's lower 31 bits flipped: XLA's total order, which
    ranks -0.0 below 0.0) above the index counted down."""
    V = scaled.shape[-1]
    bits = max(1, (V - 1).bit_length())
    i32 = scaled.float().view(torch.int32)
    mono = torch.where(i32 < 0, i32 ^ 0x7FFFFFFF, i32).long()
    rev = (1 << bits) - 1 - torch.arange(V, device=scaled.device)
    _, idx = torch.topk((mono << bits) | rev, K, dim=-1)
    return torch.gather(scaled, -1, idx), idx


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    keys: Optional[Key] = None,  # per-row keys from sample_keys, [B] each
) -> torch.Tensor:
    """Next tokens [B] (int64). temperature <= 0 selects greedy argmax and
    ``keys=None`` means every row is greedy. Sampled rows with top_p >= 1
    draw from the whole vocabulary; rows with top_p < 1 draw from the
    nucleus: the smallest prefix of the descending top-K whose softmax
    mass (over the whole vocabulary) reaches top_p, the top token always
    kept, drawn with the same key (the first K of the row's gumbels)."""
    greedy = torch.argmax(logits, dim=-1)
    if keys is None:
        return greedy
    temperature = temperature.to(logits.device, torch.float32)
    top_p = top_p.to(logits.device, torch.float32)
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    g = gumbel(keys, scaled.shape[-1])
    full = torch.argmax(g + scaled, dim=-1)
    K = min(NUCLEUS_TOP_K, scaled.shape[-1])
    top_vals, top_idx = nucleus_top_k(scaled, K)
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    top_probs = torch.exp(top_vals - lse)
    mass_before = torch.cumsum(top_probs, dim=-1) - top_probs
    keep = mass_before < top_p[:, None]
    masked = torch.where(keep, top_vals, torch.full_like(top_vals, -float("inf")))
    choice = torch.argmax(g[:, :K] + masked, dim=-1)
    pick = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    sampled = torch.where(top_p < 1.0, pick, full)
    return torch.where(temperature > 0, sampled, greedy)
