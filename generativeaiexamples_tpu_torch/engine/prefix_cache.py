"""Host-side radix index for the automatic prefix KV cache.

A copy of generativeaiexamples_tpu/engine/prefix_cache.py: its counters
(hits, misses, evictions, tokens reused) count in JAX's
``genai_engine_prefix_cache_*`` families and in plain integers under the
index's lock, read by ``stats()``.

Every chain front-loads a shared prefix (the RAG chains' system prompt
and template, ``multi_turn``'s conversation history); this index lets the
engine prefill it once:

- a **radix/trie index** over chunk-aligned token spans (one node per
  ``prefill_chunk``-sized span, keyed by the span's exact token tuple:
  content-addressed, no hash collisions);
- **entries** mapping a trie depth to a store slot that holds the
  prefix's KV rows (the fixed layout's store, ``LLMEngine._prefix_store``)
  or to refcounted pool pages (``PrefixEntry.pages``, the paged layout);
  this module never touches a tensor;
- **pins** (``refs``) holding a matched entry across the match -> fetch
  window, so LRU eviction never rewrites rows a pending fetch reads;
- **LRU eviction** over unpinned entries when the slots fill;
- optional **session hints** (``SamplingParams.prefix_hint``): a hint
  names the chain or session a request belongs to and bumps its entry's
  recency at submit time. Matching itself is content-based: hints are an
  optimization, never a correctness input.

Cached lengths are multiples of ``prefill_chunk``, so a warm request
re-enters chunked prefill exactly at a chunk boundary. A match is capped
at ``len(prompt) - 1`` tokens: the engine always runs at least one real
prefill chunk, whose logits give the first token, and a donated span
never reaches the prompt's last token.

Thread-safety: one internal lock. ``match``/``insert`` run on the engine
dispatch thread, ``touch`` on submitting threads, ``release`` on the
dispatch thread; all are short critical sections over Python state.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.utils import metrics as metrics_mod

_REG = metrics_mod.get_registry()
_M_HITS = _REG.counter(
    "genai_engine_prefix_cache_hits_total",
    "Chunked-prefill admissions that matched a cached prefix.",
)
_M_MISSES = _REG.counter(
    "genai_engine_prefix_cache_misses_total",
    "Chunked-prefill admissions that found no cached prefix.",
)
_M_EVICTIONS = _REG.counter(
    "genai_engine_prefix_cache_evictions_total",
    "Prefix entries evicted (LRU over unpinned entries) to free a store slot.",
)
_M_TOKENS_REUSED = _REG.counter(
    "genai_engine_prefix_cache_tokens_reused_total",
    "Prompt tokens served from cached KV rows instead of prefill compute.",
)
_M_ROWS_UTIL = _REG.gauge(
    "genai_engine_prefix_cache_rows_utilization_ratio",
    "Fraction of reserved prefix-cache rows holding live cached prefixes.",
)
# Slot occupancy is the ACTIONABLE sizing signal: every entry consumes a
# whole store slot regardless of its prefix length, so the rows ratio
# can sit near zero while every insert is forced to evict.
_M_SLOTS_IN_USE = _REG.gauge(
    "genai_engine_prefix_cache_slots_in_use",
    "Reserved store slots currently holding a cached prefix entry.",
)
_M_SLOTS_CAPACITY = _REG.gauge(
    "genai_engine_prefix_cache_slots_capacity",
    "Configured prefix-cache store slot count (prefix_cache_slots).",
)


class _Node:
    __slots__ = ("children", "entry", "parent")

    def __init__(self, parent: Optional["_Node"] = None) -> None:
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.entry: Optional["PrefixEntry"] = None
        self.parent = parent


class PrefixEntry:
    """A cached prefix: ``length`` chunk-aligned tokens whose KV rows
    live in reserved store slot ``store_slot`` (fixed KV layout) or in
    the refcounted pool pages listed in ``pages`` (paged layout — the
    engine sets it right after ``insert_entry`` returns; the allocator
    refcount, not the store slot, is then what keeps the rows alive)."""

    __slots__ = ("store_slot", "length", "refs", "last_use", "node", "pages")

    def __init__(self, store_slot: int, length: int, node: _Node) -> None:
        self.store_slot = store_slot
        self.length = length
        self.refs = 0
        self.last_use = 0
        self.node = node
        self.pages = None  # paged layout: List[int] of pool pages


class PrefixCache:
    """Radix index over chunk-aligned token prefixes → store slots."""

    def __init__(self, chunk: int, slots: int, max_len: int,
                 on_drop=None) -> None:
        if chunk <= 0 or slots <= 0 or max_len <= 0:
            raise ValueError(
                f"PrefixCache needs positive chunk/slots/max_len, got "
                f"chunk={chunk} slots={slots} max_len={max_len}"
            )
        self.chunk = chunk
        self.capacity = slots
        self.max_len = max_len
        # Called (under the cache lock) with every entry that leaves the
        # index — LRU eviction, slot invalidation, subsumed-ancestor
        # consolidation. The paged engine hooks this to release the
        # entry's refcounted pool pages; the hook must not call back
        # into this cache.
        self._on_drop = on_drop
        self._root = _Node()  # guarded by self._lock
        self._free: List[int] = list(range(slots))  # guarded by self._lock
        self._entries: List[PrefixEntry] = []  # guarded by self._lock
        self._hints: Dict[str, PrefixEntry] = {}  # guarded by self._lock
        self._tick = 0  # guarded by self._lock
        self.hits = 0  # guarded by self._lock
        self.misses = 0  # guarded by self._lock
        self.evictions = 0  # guarded by self._lock
        self.tokens_reused = 0  # guarded by self._lock
        self._lock = threading.Lock()
        _M_ROWS_UTIL.set(0.0)
        _M_SLOTS_IN_USE.set(0)
        _M_SLOTS_CAPACITY.set(slots)

    # -- internals (caller holds self._lock) ---------------------------- #
    def _cap(self, n: int) -> int:
        """Largest chunk-aligned cacheable length for an n-token prompt:
        a multiple of ``chunk``, <= n-1 (one chunk of real prefill always
        remains to produce first-token logits), <= store row capacity."""
        c = min(n - 1, self.max_len)
        return (c // self.chunk) * self.chunk if c >= self.chunk else 0

    def _spans(self, ids: Sequence[int], upto: int):
        for i in range(0, upto, self.chunk):
            yield tuple(ids[i:i + self.chunk])

    def _walk(self, ids: Sequence[int], cap: int) -> Tuple[_Node, int]:
        """Deepest trie node whose root-path spans equal ``ids``' chunks
        (up to ``cap`` tokens), plus its depth in tokens. Caller holds
        self._lock."""
        node, depth = self._root, 0
        for key in self._spans(ids, cap):
            child = node.children.get(key)
            if child is None:
                break
            node, depth = child, depth + self.chunk
        return node, depth

    @staticmethod
    def _subtree_entry(node: _Node) -> Optional[PrefixEntry]:
        """Any entry at-or-below ``node``. A radix cache serves PARTIAL
        prefixes: if an entry's prompt shares this node's root path, its
        store rows [0:depth] are exactly the KV for that shared prefix
        (rows are causal — they depend only on preceding tokens), so any
        subtree entry can serve a match at this node's depth."""
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    # Session hints are unbounded user input (one per conversation):
    # cap the map so a long-running server can't leak a dict entry per
    # conversation forever. Oldest-bound wins eviction — the entries
    # themselves are untouched (hints are advisory recency only).
    _HINT_CAP = 256

    def _bind_hint(self, hint: str, entry: PrefixEntry) -> None:
        """Bind a session hint to an entry (bounded map). Caller holds
        self._lock."""
        if hint in self._hints:
            del self._hints[hint]  # re-insert to refresh dict order
        self._hints[hint] = entry
        while len(self._hints) > self._HINT_CAP:
            self._hints.pop(next(iter(self._hints)))

    def _update_gauge(self) -> None:
        """Refresh the rows/slots gauges. Caller holds self._lock."""
        used = sum(e.length for e in self._entries)
        _M_ROWS_UTIL.set(used / (self.capacity * self.max_len))
        _M_SLOTS_IN_USE.set(self.capacity - len(self._free))

    def _evict_one(self) -> Optional[int]:
        """Free the LRU unpinned entry's store slot; None if every entry
        is pinned by a live request (refs > 0) — insertion then skips
        rather than corrupting rows under a live decode. Caller holds
        self._lock."""
        victims = [e for e in self._entries if e.refs == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda e: e.last_use)
        victim.node.entry = None
        self._entries.remove(victim)
        if self._on_drop is not None:
            self._on_drop(victim)
        for hint in [h for h, e in self._hints.items() if e is victim]:
            del self._hints[hint]
        # Prune now-useless trie branches (no entry anywhere below):
        # partial matches resolve through subtree entries, so childless
        # entry-less nodes can never serve one again.
        node = victim.node
        while (
            node is not None
            and node.parent is not None
            and not node.children
            and node.entry is None
        ):
            parent = node.parent
            for key, child in list(parent.children.items()):
                if child is node:
                    del parent.children[key]
                    break
            node = parent
        self.evictions += 1
        _M_EVICTIONS.inc()
        return victim.store_slot

    # -- engine-facing API ---------------------------------------------- #
    def match(self, ids: Sequence[int],
              hint: Optional[str] = None) -> Optional[Tuple[PrefixEntry, int]]:
        """Deepest cached prefix of ``ids``: returns (entry, length)
        with length chunk-aligned and < len(ids); the entry is pinned
        (refs+1) until the engine calls ``release``. The length may be
        SHORTER than the entry — a radix cache serves any prefix of a
        cached prefix from the same store rows (they're causal). None —
        and a miss counted — when nothing is cached; prompts too short
        to ever reuse a chunk (len <= chunk) return None without
        counting."""
        with self._lock:
            cap = self._cap(len(ids))
            if cap <= 0:
                return None
            self._tick += 1
            node, depth = self._walk(ids, cap)
            entry = self._subtree_entry(node) if depth > 0 else None
            if entry is None:
                self.misses += 1
                _M_MISSES.inc()
                return None
            length = min(depth, entry.length)
            entry.refs += 1
            entry.last_use = self._tick
            if hint:
                self._bind_hint(hint, entry)
            self.hits += 1
            self.tokens_reused += length
            _M_HITS.inc()
            _M_TOKENS_REUSED.inc(length)
            return entry, length

    def release(self, entry: PrefixEntry) -> None:
        """Unpin a matched entry (the request left its decode slot)."""
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    def invalidate_slot(self, slot: int) -> bool:
        """Drop the entry occupying ``slot`` (engine warmup is about to
        scribble on its rows) and return the slot to the free list.
        True when the slot is free afterwards; False if a pinned entry
        holds it — the caller must then not touch the rows."""
        with self._lock:
            entry = next(
                (e for e in self._entries if e.store_slot == slot), None
            )
            if entry is None:
                return True
            if entry.refs > 0:
                return False
            entry.node.entry = None
            self._entries.remove(entry)
            if self._on_drop is not None:
                self._on_drop(entry)
            for h in [h for h, e in self._hints.items() if e is entry]:
                del self._hints[h]
            self._free.append(slot)
            self.evictions += 1
            _M_EVICTIONS.inc()
            self._update_gauge()
            return True

    def evict_lru(self) -> bool:
        """Drop the LRU unpinned entry and free its slot — page-pool
        backpressure: the paged engine calls this when an admission
        cannot fund its page reservation, reclaiming pages held only by
        cold cached prefixes (the drop hook releases them). False when
        every entry is pinned (or the cache is empty)."""
        with self._lock:
            slot = self._evict_one()
            if slot is None:
                return False
            self._free.append(slot)
            self._update_gauge()
            return True

    def touch(self, hint: str) -> None:
        """Session keep-alive: bump the hinted entry's recency so an
        active session's prefix survives LRU pressure between turns."""
        with self._lock:
            entry = self._hints.get(hint)
            if entry is not None:
                self._tick += 1
                entry.last_use = self._tick

    def insert(self, ids: Sequence[int],
               hint: Optional[str] = None) -> Optional[Tuple[int, int]]:
        """Register ``ids``' chunk-aligned prefix after its prefill
        completed. Returns (store_slot, length) for the engine to copy
        rows into, or None when the prefix is already cached at full
        depth, uncacheable, or every store slot is pinned."""
        entry = self.insert_entry(ids, hint=hint)
        if entry is None:
            return None
        return entry.store_slot, entry.length

    def insert_entry(self, ids: Sequence[int],
                     hint: Optional[str] = None) -> Optional[PrefixEntry]:
        """``insert`` returning the entry itself — the paged engine
        needs it to attach the donated page list (``entry.pages``)
        instead of running a slot->store copy program."""
        with self._lock:
            cap = self._cap(len(ids))
            if cap <= 0:
                return None
            have, depth = self._walk(ids, cap)
            sub = self._subtree_entry(have)
            if depth >= cap and sub is not None:
                return None  # every cacheable row already served
            # Branch-point heuristic: diverging INSIDE a cached branch
            # (an entry continues deeper than our walk, and no entry
            # ends exactly where we diverged) with MOST of our cacheable
            # prefix already served means this prompt shares the
            # preamble but carries a one-off sibling tail (a RAG
            # question, a per-request context) — caching it would pay a
            # whole-prompt copy and burn a store slot per request for
            # rows partial matching already serves. Pure EXTENSIONS (an
            # entry ends exactly at our matched depth — e.g. a chat
            # history that grew by a turn) still deepen, with ancestor
            # consolidation keeping that to one slot per conversation;
            # and a mostly-new prompt (shared depth < half its cap —
            # e.g. a different chain whose template merely opens with
            # the same chunk) still caches its own prefix.
            if (
                sub is not None
                and have.entry is None
                and 0 < depth < sub.length
                and depth * 2 >= cap
            ):
                return None
            node = self._root
            subsumed: List[PrefixEntry] = []
            for key in self._spans(ids, cap):
                child = node.children.get(key)
                if child is None:
                    child = _Node(parent=node)
                    node.children[key] = child
                node = child
                if child.entry is not None and child.entry.refs == 0:
                    subsumed.append(child.entry)
            # Consolidate unpinned ANCESTOR entries along this path: the
            # new deeper entry serves every prefix they served (partial
            # matching), so their slots are pure duplication — reclaim
            # them instead of LRU-evicting other chains' preambles (a
            # growing multi-turn conversation would otherwise fill the
            # store with nested copies of itself). Not counted as
            # evictions: no cached content becomes unservable.
            for dup in subsumed:
                dup.node.entry = None
                self._entries.remove(dup)
                if self._on_drop is not None:
                    self._on_drop(dup)
                for h in [h for h, e in self._hints.items() if e is dup]:
                    del self._hints[h]
                self._free.append(dup.store_slot)
            if self._free:
                slot = self._free.pop()
            else:
                slot = self._evict_one()
                if slot is None:
                    return None
            self._tick += 1
            entry = PrefixEntry(slot, cap, node)
            entry.last_use = self._tick
            node.entry = entry
            self._entries.append(entry)
            if hint:
                self._bind_hint(hint, entry)
            self._update_gauge()
            return entry

    # -- introspection --------------------------------------------------- #
    def stats(self) -> Dict[str, float]:
        """The JAX index's ``stats()`` and its counters: ``hits`` and
        ``misses`` of chunked admissions, ``evictions`` (LRU and
        invalidation; consolidation is not one) and ``tokens_reused``."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "free_slots": len(self._free),
                "cached_rows": sum(e.length for e in self._entries),
                "capacity_rows": self.capacity * self.max_len,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "tokens_reused": self.tokens_reused,
            }
