"""Ring attention: causal sequence parallelism over a mesh's ``seq`` axis.

Counterpart of generativeaiexamples_tpu/parallel/ring_attention.py. The
sequence is cut on T over the ``seq`` devices of the mesh (its
:meth:`~parallel.mesh.Mesh.ring`); each shard keeps its queries and a
running f32 online softmax (``m``, ``l``, ``o``), and the K/V blocks hop
one shard around the ring per step, ``P`` hops in all, as JAX's
``lax.ppermute`` loop does: no shard ever holds the full ``[T, T]`` scores
or the full K/V at once.

The arithmetic is JAX's, step for step: f32 scores scaled by
``1/sqrt(D)``, the causal mask on global positions, masked ``p`` forced
to 0 (a row whose block is all masked would otherwise add
``exp(-inf - -inf) = 1``), then one division and one cast at the end. It
is plain PyTorch, as JAX's is plain einsum: no Pallas kernel runs here.
A hop is ``.to(next device, copy=True)``, a copy even where the ring
names one device more than once, so a one-card ring moves the bytes a
multi-card ring would.
"""
from __future__ import annotations

import math

import torch

from generativeaiexamples_tpu_torch.parallel.mesh import SEQ_AXIS, Mesh

_NEG_INF = -1e30


def _repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """GQA K/V broadcast to the query heads (``jnp.repeat`` on the head
    axis: each KV head ``group`` times in a row)."""
    if k.shape[2] != q.shape[2]:
        group = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    return k, v


def ring_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    causal: bool = True,
) -> torch.Tensor:
    """Sequence-parallel attention over the mesh's ``seq`` ring: ``q``,
    ``k`` and ``v`` cut on T into one block a ``seq`` shard, each block on
    its shard's device; the output ``[B, T, Hq, D]`` in ``q``'s dtype,
    whole on ``q``'s device. GQA K/V are repeated to the query heads
    before the ring, as in JAX."""
    if axis_name != SEQ_AXIS:
        raise ValueError(f"ring attention runs over the {SEQ_AXIS!r} axis, not {axis_name!r}")
    k, v = _repeat_kv(q, k, v)
    ring = mesh.ring()
    n = len(ring)
    B, T, H, D = q.shape
    if T % n:
        raise ValueError(f"sequence of {T} not divisible by {n} seq shards")
    Tq = T // n
    scale = 1.0 / math.sqrt(D)
    qs = [c.to(dev).float() for c, dev in zip(torch.chunk(q, n, dim=1), ring)]
    k_blk = [c.to(dev) for c, dev in zip(torch.chunk(k, n, dim=1), ring)]
    v_blk = [c.to(dev) for c, dev in zip(torch.chunk(v, n, dim=1), ring)]
    m = [torch.full((B, H, Tq), _NEG_INF, dtype=torch.float32, device=dev) for dev in ring]
    l = [torch.zeros((B, H, Tq), dtype=torch.float32, device=dev) for dev in ring]
    o = [torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev) for dev in ring]
    for step in range(n):
        for i, dev in enumerate(ring):
            kv_idx = (i - step) % n
            scores = torch.einsum("bthd,bshd->bhts", qs[i], k_blk[i].float()) * scale
            if causal:
                q_pos = i * Tq + torch.arange(Tq, device=dev)
                k_pos = kv_idx * Tq + torch.arange(Tq, device=dev)
                masked = (q_pos[:, None] < k_pos[None, :])[None, None]
                scores = scores.masked_fill(masked, _NEG_INF)
            new_m = torch.maximum(m[i], scores.amax(dim=-1))
            p = torch.exp(scores - new_m[..., None])
            if causal:
                p = p.masked_fill(masked, 0.0)
            correction = torch.exp(m[i] - new_m)
            l[i] = l[i] * correction + p.sum(dim=-1)
            blk_o = torch.einsum("bhts,bshd->bthd", p, v_blk[i].float())
            o[i] = o[i] * correction.transpose(1, 2)[..., None] + blk_o
            m[i] = new_m
        # one hop: shard i's block to shard i + 1's device
        k_blk = [k_blk[(i - 1) % n].to(dev, copy=True) for i, dev in enumerate(ring)]
        v_blk = [v_blk[(i - 1) % n].to(dev, copy=True) for i, dev in enumerate(ring)]
    outs = [(o[i] / torch.clamp(l[i], min=1e-30).transpose(1, 2)[..., None]).to(q.dtype)
            for i in range(n)]
    return torch.cat([x.to(q.device) for x in outs], dim=1)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """One-device reference for ring_attention's numerics (JAX's): f32
    scores over the whole sequence, a softmax, one cast."""
    k, v = _repeat_kv(q, k, v)
    T, D = q.shape[1], q.shape[3]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(D)
    if causal:  # in place: at T = 8192 the scores alone are 8.6 GB a 32-head row
        above = torch.ones((T, T), dtype=torch.bool, device=q.device).triu_(1)
        scores.masked_fill_(above[None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, v.float()).to(q.dtype)
