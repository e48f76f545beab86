"""Consistent-hash placement with bounded-load spill (pure host).

Counterpart of generativeaiexamples_tpu/router/ring.py, copied: the
ring points (``_point``, sha256's first 8 bytes) are the JAX router's
bit for bit, so both routers place every key on the same replica and
the replicas' prefix caches survive a swap of one router for the other.

The ring maps a request's *prefix key* — the stable identity the
engine's radix prefix cache will see again (conversation first
message, repeated question text) — onto the replica that most likely
already holds the matching KV pages. Properties the tier-1 tests pin:

- **distribution**: with ``vnodes`` virtual points per replica, key
  load across 2–8 replicas stays within a bounded factor of fair
  share;
- **minimal movement**: adding/removing one replica remaps only the
  keys that replica owns/owned (≈ K/N), never shuffling the rest —
  a replica join does not cold-start the whole fleet's caches;
- **bounded-load spill**: when the owner is saturated (the caller's
  ``saturated`` predicate — inflight vs. fair share, last-seen queue
  depth), placement walks the ring to the next *eligible* replica
  deterministically instead of queueing behind a hot spot;
- **drain**: eligibility is the caller's set — a draining replica
  simply stops appearing in it, which removes it from new placement
  without touching anything it is already serving.
"""
from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

DEFAULT_VNODES = 64


def _point(label: str) -> int:
    """64-bit ring coordinate for a label (stable across processes —
    placement must agree between router restarts for caches to
    survive a rolling restart)."""
    digest = hashlib.sha256(label.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


def hash_key(key: str) -> int:
    return _point("key:" + key)


@dataclass(frozen=True)
class Placement:
    """One placement decision."""

    replica: Optional[str]
    outcome: str  # affinity | spill | round_robin | none


class HashRing:
    """Consistent-hash ring over replica ids with virtual nodes.

    Thread-safe: membership changes (health-poller thread) and lookups
    (event loop) synchronize on one lock; lookups copy nothing — they
    bisect the sorted point list in place.
    """

    def __init__(self, replicas: Iterable[str] = (), vnodes: int = DEFAULT_VNODES):
        if vnodes <= 0:
            raise ValueError(f"vnodes must be > 0, got {vnodes}")
        self._vnodes = vnodes
        self._lock = threading.Lock()
        self._members: List[str] = []             # guarded by self._lock
        self._points: List[Tuple[int, str]] = []  # guarded by self._lock
        for r in replicas:
            self.add(r)

    @property
    def vnodes(self) -> int:
        return self._vnodes

    def members(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(self._members)

    def add(self, replica: str) -> None:
        with self._lock:
            if replica in self._members:
                return
            self._members.append(replica)
            for v in range(self._vnodes):
                pt = (_point(f"replica:{replica}#{v}"), replica)
                bisect.insort(self._points, pt)

    def remove(self, replica: str) -> None:
        with self._lock:
            if replica not in self._members:
                return
            self._members.remove(replica)
            self._points = [p for p in self._points if p[1] != replica]

    def __len__(self) -> int:
        with self._lock:
            return len(self._members)

    def owner(self, key: str) -> Optional[str]:
        """The replica owning ``key`` (first point clockwise)."""
        for r in self.walk(key):
            return r
        return None

    def walk(self, key: str) -> Iterator[str]:
        """Distinct replicas in ring order starting at the key's owner.

        The walk order is deterministic per key, which makes spill and
        failover targets reproducible: the same overloaded owner always
        spills the same key to the same sibling (so the sibling's cache
        warms for exactly the spilled keys, not a random subset).
        """
        with self._lock:
            points = list(self._points)
        if not points:
            return
        idx = bisect.bisect_right(points, (hash_key(key), chr(0x10FFFF)))
        seen = set()
        for i in range(len(points)):
            _, replica = points[(idx + i) % len(points)]
            if replica not in seen:
                seen.add(replica)
                yield replica


class AffinityPlacer:
    """Prefix-affinity placement over a :class:`HashRing` with
    bounded-load spill.

    ``saturated(replica)`` is the caller's load predicate (router
    inflight vs. bounded-load fair share, last-seen admission queue
    depth). Placement walks the ring from the key's owner and takes
    the first eligible, unsaturated replica; when *every* eligible
    replica is saturated it falls back to the first eligible one in
    walk order (the bound is advisory — each replica still has its own
    admission control to shed the overflow).
    """

    def __init__(self, ring: HashRing,
                 saturated: Optional[Callable[[str], bool]] = None):
        self.ring = ring
        self._saturated = saturated or (lambda replica: False)

    def place(self, key: str, eligible: Sequence[str]) -> Placement:
        """The key's *effective owner* is the first eligible replica in
        ring-walk order (an ineligible true owner — drained, unhealthy
        — consistently remaps to the same successor, so the successor's
        cache warms for exactly the inherited keys). Outcome is
        ``affinity`` when the effective owner serves, ``spill`` when
        saturation pushed past it."""
        eligible_set = set(eligible)
        if not eligible_set:
            return Placement(None, "none")
        first_eligible: Optional[str] = None
        for replica in self.ring.walk(key):
            if replica not in eligible_set:
                continue
            if first_eligible is None:
                first_eligible = replica
            if not self._saturated(replica):
                outcome = "affinity" if replica == first_eligible else "spill"
                return Placement(replica, outcome)
        # All eligible replicas saturated: keep locality rather than
        # inventing a queue the replicas already have (each replica's
        # own admission control sheds the overflow).
        if first_eligible is not None:
            return Placement(first_eligible, "affinity")
        return Placement(None, "none")


class RoundRobinPlacer:
    """Blind round-robin baseline (the A/B control for the bench:
    placement ignores the key entirely)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0  # guarded by self._lock

    def place(self, key: str, eligible: Sequence[str]) -> Placement:
        ordered = sorted(eligible)
        if not ordered:
            return Placement(None, "none")
        with self._lock:
            replica = ordered[self._next % len(ordered)]
            self._next += 1
        return Placement(replica, "round_robin")
