"""The port's automatic prefix KV cache on the CPU (every kernel wrapper runs
its plain version), against the JAX package's:

- the radix index (engine/prefix_cache.py): seeded operation sequences
  (match, insert, insert_entry, release, touch, evict_lru,
  invalidate_slot) through JAX's ``PrefixCache`` and the port's give the
  same answers, store slots, entries, hints, ``stats()`` and counters;
- the engine, with the cases of JAX's tests/test_prefix_cache.py on its
  ``TINY`` config (debug model, ``prefill_chunk`` 16, float32), on the
  paged and the fixed layout, bf16 and int8: warm streams are
  token-identical to a cache-off engine's, a warm request runs 1 chunk
  where a cold one runs 3, eviction under a full store stays correct, a
  mixed wave decodes every row as its cold reference, and a failed wave
  unwinds its slots and pins;
- the hazards of sharing rows: pins and refcounts on every exit path
  (backpressure requeue, a failed wave, abort between match and insert,
  shutdown), donated pages bitwise unchanged under ``decode_runahead`` 4,
  skipped chunks that leave fetched rows alone, the fixed store's copy
  order and pins, and a dispatch thread that never reads the device;
- the config (JAX's messages from ``EngineConfig.validate`` and
  ``config_validate``; ``off`` and 0 slots build no cache) and the
  backend, which hands the chains' hint to ``submit``.

Last, the same prompt sequence through the JAX engine and the port, on the
same weights: equal streams, hits, misses, tokens reused and chunks."""
import threading
import time

import numpy as np
import pytest
import torch

from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.config.validate import validate_config as jvalidate
from generativeaiexamples_tpu.engine import prefix_cache as jpc
from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine import kv_pages, prefix_cache
from generativeaiexamples_tpu_torch.engine.llm_backend import TorchLLMBackend
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from tests.test_torch_config_validate import _port_starts, env  # noqa: F401 - env is a fixture
from tests.test_torch_engine import entry_pages

TINY = dict(
    model_config_name="debug", max_batch_size=4, max_seq_len=128, prefill_chunk=16,
    decode_block=2, dtype="float32", page_size=8,
)
PRE = [(i * 7) % 250 + 1 for i in range(32)]  # 2 chunks, shared preamble
TAILS = {"q1": [3, 4, 5, 6, 7], "q2": [9, 10, 11, 12], "q3": [30, 31, 32, 33, 34, 35]}
OTHER = [(i * 5) % 240 + 1 for i in range(32)]  # another 2-chunk preamble
LONG = [(i * 3) % 200 + 1 for i in range(41)]
SHORT = [1, 9, 27]
LAYOUTS = ["paged", "fixed"]
RECIPES = [("paged", "bfloat16"), ("fixed", "bfloat16"), ("paged", "int8"), ("fixed", "int8")]
RECIPE_IDS = [f"{layout}-{kv}" for layout, kv in RECIPES]


# --------------------------------------------------------------------------- #
# The radix index against JAX's


def _answer(m):
    """A match/insert_entry result as comparable values."""
    if m is None:
        return None
    if isinstance(m, tuple) and not isinstance(m[0], int):
        return (m[0].store_slot, m[0].length), m[1]
    if isinstance(m, tuple):
        return m
    return m.store_slot, m.length


def _state(cache):
    """Entries (slot, length, pins, recency) and hints, in a comparable form."""
    with cache._lock:
        entries = sorted((e.store_slot, e.length, e.refs, e.last_use) for e in cache._entries)
        hints = {h: (e.store_slot, e.length) for h, e in cache._hints.items()}
    return entries, hints


@pytest.mark.parametrize("seed", range(10))
def test_index_matches_jax_on_seeded_operation_sequences(seed):
    rng = np.random.default_rng(seed)
    chunk = int(rng.choice([2, 4]))
    slots = int(rng.integers(1, 4))
    max_len = int(rng.choice([8, 32]))
    ref, mine = jpc.PrefixCache(chunk, slots, max_len), prefix_cache.PrefixCache(chunk, slots, max_len)
    # few distinct preambles and a tiny alphabet: prompts share and diverge
    preambles = [[int(t) for t in rng.integers(1, 4, size=int(rng.integers(0, 4 * chunk)))]
                 for _ in range(3)]
    hints = ["chain:a", "chain:b", "conv:c", None]
    pinned = []  # (JAX entry, port entry) of unreleased matches
    before = jpc.metrics_snapshot()
    for _ in range(300):
        op = str(rng.choice(["match", "match", "insert", "insert_entry", "release", "touch",
                             "evict_lru", "invalidate_slot"]))
        prompt = preambles[int(rng.integers(3))] + [
            int(t) for t in rng.integers(1, 4, size=int(rng.integers(0, 2 * chunk + 2)))]
        hint = hints[int(rng.integers(len(hints)))]
        if op == "match":
            got, want = mine.match(prompt, hint), ref.match(prompt, hint)
            assert _answer(got) == _answer(want)
            if want is not None:
                pinned.append((want[0], got[0]))
        elif op == "insert":
            assert mine.insert(prompt, hint) == ref.insert(prompt, hint)
        elif op == "insert_entry":
            assert _answer(mine.insert_entry(prompt, hint)) == _answer(ref.insert_entry(prompt, hint))
        elif op == "release" and pinned:
            want, got = pinned.pop(int(rng.integers(len(pinned))))
            ref.release(want)
            mine.release(got)
        elif op == "touch" and hint:
            ref.touch(hint)
            mine.touch(hint)
        elif op == "evict_lru":
            assert mine.evict_lru() == ref.evict_lru()
        elif op == "invalidate_slot":
            slot = int(rng.integers(slots))
            assert mine.invalidate_slot(slot) == ref.invalidate_slot(slot)
        assert _state(mine) == _state(ref)
        with ref._lock, mine._lock:
            assert sorted(mine._free) == sorted(ref._free)
        got_stats, want_stats = mine.stats(), ref.stats()
        assert {k: got_stats[k] for k in want_stats} == want_stats
        now = jpc.metrics_snapshot()
        for key in ("hits", "misses", "evictions", "tokens_reused"):
            assert got_stats[key] == now["prefix_cache_" + key] - before["prefix_cache_" + key], key


def test_index_cap_keeps_a_chunk_of_prefill_and_the_last_token():
    """The cap of JAX's index, kept exactly: a match or an insert is a
    multiple of the chunk below the prompt's length, so the span a request
    donates never reaches its last token and one chunk always runs."""
    for n in range(1, 40):
        mine, ref = prefix_cache.PrefixCache(4, 2, 24), jpc.PrefixCache(4, 2, 24)
        assert mine._cap(n) == ref._cap(n)
        assert mine._cap(n) % 4 == 0 and mine._cap(n) <= max(0, n - 1)
        ins = mine.insert(list(range(1, n + 1)))
        assert ins == ref.insert(list(range(1, n + 1)))
        assert ins is None or ins[1] < n


# --------------------------------------------------------------------------- #
# The engine (the cases of JAX's tests/test_prefix_cache.py)


def _engine(layout="paged", kv="bfloat16", **overrides):
    return LLMEngine(EngineConfig(**dict(TINY, kv_layout=layout, kv_cache_dtype=kv, **overrides)),
                     device="cpu")


def _greedy(eng, prompt, n=6, hint=None):
    params = SamplingParams(temperature=0.0, max_tokens=n, prefix_hint=hint)
    return list(eng.iter_ids(prompt, params, timeout=120))


def _drain(req, timeout=120):
    out = []
    while (tok := req.out_queue.get(timeout=timeout)) is not None:
        out.append(tok)
    return out


@pytest.fixture(scope="module")
def cold():
    """``cold(layout, kv, prompt, n)``: the greedy stream of a
    cache-off engine of that recipe (one engine a recipe, kept)."""
    engines = {}

    def run(layout, kv, prompt, n=6):
        if (layout, kv) not in engines:
            engines[layout, kv] = _engine(layout, kv, prefix_cache_enable="off")
            assert engines[layout, kv]._prefix is None
        return _greedy(engines[layout, kv], prompt, n)

    yield run
    for eng in engines.values():
        assert eng.shutdown()


def _settle(eng, timeout=60.0):
    """Wait until every slot is back and every readback emitted."""
    deadline = time.time() + timeout
    while (eng._slot_req or not eng._readback.empty()) and time.time() < deadline:
        time.sleep(0.01)
    assert not eng._slot_req and eng._readback.empty()
    return eng.stats()


def _assert_unpinned(eng):
    """Every slot back, no entry pinned, and on the paged layout every page
    in use held by an entry."""
    stats = _settle(eng)
    assert sorted(eng._free_slots) == list(range(eng.num_slots))
    with eng._prefix._lock:
        assert all(e.refs == 0 for e in eng._prefix._entries)
    if eng._paged:
        assert stats["pages_in_use"] == entry_pages(eng)
    return stats


@pytest.mark.parametrize("layout,kv", RECIPES, ids=RECIPE_IDS)
def test_warm_hit_skips_chunks_and_is_token_identical(cold, layout, kv):
    eng = _engine(layout, kv, prefix_cache_slots=2)
    try:
        assert eng._prefix is not None
        m0 = eng.stats()
        out1 = _greedy(eng, PRE + TAILS["q1"], hint="rag:test")
        m1 = eng.stats()
        # cold: the full chunk set, one miss, the prefix inserted
        assert m1["prefill_chunks"] - m0["prefill_chunks"] == 3
        assert (m1["prefix_cache_misses"], m1["prefix_cache_hits"]) == (1, 0)
        assert out1 == cold(layout, kv, PRE + TAILS["q1"])
        out2 = _greedy(eng, PRE + TAILS["q2"], hint="rag:test")
        m2 = eng.stats()
        # warm: the suffix chunk only, one hit, 32 preamble tokens reused
        assert m2["prefill_chunks"] - m1["prefill_chunks"] == 1
        assert m2["prefix_cache_hits"] == 1 and m2["prefix_cache_tokens_reused"] == 32
        assert out2 == cold(layout, kv, PRE + TAILS["q2"])
        # prefill_tokens still counts whole prompts
        assert m2["prefill_tokens"] - m1["prefill_tokens"] == len(PRE + TAILS["q2"])
        assert "rag:test" in eng._prefix._hints
        if layout == "paged":
            assert (m2["prefix_pages_mapped"], m2["prefix_copy_dispatches"]) == (32 // 8, 0)
        else:  # one insert, one fetch
            assert (m2["prefix_pages_mapped"], m2["prefix_copy_dispatches"]) == (0, 2)
        _assert_unpinned(eng)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_repeated_full_prompt_still_prefills_last_chunk(cold, layout):
    """An exact repeat of a cached prompt still runs its last chunk (the
    match caps at len - 1) and streams the same."""
    eng = _engine(layout, prefix_cache_slots=2)
    try:
        out1 = _greedy(eng, PRE + TAILS["q3"])
        c0 = eng.stats()["prefill_chunks"]
        out2 = _greedy(eng, PRE + TAILS["q3"])
        assert eng.stats()["prefill_chunks"] - c0 == 1
        assert out1 == out2 == cold(layout, "bfloat16", PRE + TAILS["q3"])
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_eviction_under_full_store_stays_correct(cold, layout):
    """One slot, two preambles in turn: each insert evicts the other, and
    every stream still equals its cold reference."""
    eng = _engine(layout, prefix_cache_slots=1)
    try:
        prompts = {"a": PRE + [1, 2], "b": OTHER + [3, 4]}
        first = {name: _greedy(eng, p) for name, p in prompts.items()}  # b evicts a
        again = {name: _greedy(eng, p) for name, p in prompts.items()}  # a misses, evicts b
        stats = _assert_unpinned(eng)
        assert stats["prefix_cache_evictions"] >= 2
        assert first == again == {name: cold(layout, "bfloat16", p) for name, p in prompts.items()}
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout,kv", RECIPES, ids=RECIPE_IDS)
def test_mixed_wave_with_partial_hits(cold, layout, kv):
    """One admission wave of a warm row, a cold long row and a short row:
    every stream equals its cold reference."""
    eng = _engine(layout, kv, prefix_cache_slots=2)
    try:
        _greedy(eng, PRE + TAILS["q1"])  # populate the cache
        greedy = SamplingParams(temperature=0.0, max_tokens=6)
        with eng.hold_admissions():
            reqs = {"q2": eng.submit(PRE + TAILS["q2"], greedy),
                    "long": eng.submit(LONG, greedy), "short": eng.submit(SHORT, greedy)}
        got = {name: _drain(req) for name, req in reqs.items()}
        stats = _assert_unpinned(eng)
        assert stats["prefix_cache_hits"] == 1 and stats["prefill_waves"] == 3
        assert got == {"q2": cold(layout, kv, PRE + TAILS["q2"]), "long": cold(layout, kv, LONG),
                       "short": cold(layout, kv, SHORT)}
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_admission_failure_unwinds_slots_and_pins(cold, layout):
    """A prefill dispatch that fails fails its request (error, then the
    end), returns its slot and unpins its match; the engine keeps
    serving."""
    eng = _engine(layout, prefix_cache_slots=2)
    try:
        _greedy(eng, PRE + TAILS["q1"])
        boom = RuntimeError("synthetic dispatch failure")
        orig, state = eng._prefill_chunked, {"fail": True}

        def failing(*args, **kwargs):
            if state["fail"]:
                state["fail"] = False
                raise boom
            return orig(*args, **kwargs)

        eng._prefill_chunked = failing
        req = eng.submit(PRE + TAILS["q2"], SamplingParams(temperature=0.0, max_tokens=4))
        assert req.out_queue.get(timeout=120) is None  # failed fast
        assert req.error is boom and eng.stats()["prefix_cache_hits"] == 1
        _assert_unpinned(eng)
        assert _greedy(eng, PRE + TAILS["q2"]) == cold(layout, "bfloat16", PRE + TAILS["q2"])
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("overrides", [dict(prefix_cache_enable="off"), dict(prefix_cache_slots=0)],
                         ids=["off", "zero-slots"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_off_keeps_the_admission_path(cold, layout, overrides):
    """``off`` or no slots: no index, no store, a pool of the decode slots'
    strips only, every repeat re-prefills its whole prompt, and the
    counters stay at 0."""
    eng = _engine(layout, **overrides)
    try:
        assert eng._prefix is None and eng._prefix_store is None
        assert eng.prefix_cache_bytes() == 0
        if layout == "paged":
            assert eng._pool_pages == kv_pages.pool_pages(eng.engine_config, 128) == 1 + 4 * 16
        for _ in range(2):
            c0 = eng.stats()["prefill_chunks"]
            assert _greedy(eng, PRE + TAILS["q1"]) == cold(layout, "bfloat16", PRE + TAILS["q1"])
            assert eng.stats()["prefill_chunks"] - c0 == 3
        stats = eng.stats()
        assert all(stats[k] == 0 for k in (
            "prefix_cache_hits", "prefix_cache_misses", "prefix_cache_evictions",
            "prefix_cache_tokens_reused", "prefix_pages_mapped", "prefix_copy_dispatches"))
        if layout == "paged":
            assert _settle(eng)["pages_in_use"] == 0
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_jax_default_builds_a_cache_on_both_layouts(layout, kv):
    """``prefix_cache_enable='auto'`` with 4 slots, the defaults: the paged
    pool gets one strip per slot, the fixed layout a store of 4 strips in
    the slot cache's own layout (int8 head-major with f32 scales)."""
    eng = _engine(layout, kv)
    try:
        assert eng.engine_config.prefix_cache_enable == "auto"
        assert eng._prefix is not None and eng._prefix.capacity == 4
        cfg = eng.model_config
        if layout == "paged":
            assert eng._prefix_store is None
            assert eng._pool_pages == 1 + (4 + 4) * 16
            per_page = sum(t[0].numel() * t.element_size() for c in eng._cache for t in c.values())
            assert eng.prefix_cache_bytes() == 4 * 16 * per_page
        else:
            store, cache = eng._prefix_store, eng._cache
            assert len(store) == cfg.num_layers
            for key in cache[0]:
                assert store[0][key].shape[0] == 4 and store[0][key].shape[1:] == cache[0][key].shape[1:]
                assert store[0][key].dtype == cache[0][key].dtype
            assert ("ks" in store[0]) == (kv == "int8")
            assert eng.prefix_cache_bytes() == sum(
                t.numel() * t.element_size() for c in store for t in c.values())
    finally:
        assert eng.shutdown()


# --------------------------------------------------------------------------- #
# Hazards


def test_backpressure_requeue_unpins_every_later_claim(cold):
    """A pool of one strip: a live request holds most of it, so the first
    claim of a wave cannot be funded, and the entry it could evict is
    pinned by the warm claim behind it. Both go back to the queue with the
    pin released, and both stream their cold references once pages free."""
    eng = _engine("paged", kv_pool_pages=17)  # one 16-page strip + scratch
    try:
        _greedy(eng, PRE + TAILS["q1"])  # an entry of 4 pages
        hog = eng.submit([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=80))  # 11 pages
        assert hog.out_queue.get(timeout=120) is not None
        greedy = SamplingParams(temperature=0.0, max_tokens=6)
        big = SamplingParams(temperature=0.0, max_tokens=20)  # 41 + 20 + slack: 8 pages
        with eng.hold_admissions():
            first = eng.submit(LONG, big)
            warm = eng.submit(PRE + TAILS["q2"], greedy)
        deadline = time.time() + 60
        while eng.stats()["page_alloc_failures"] < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert eng.stats()["page_alloc_failures"] >= 1
        eng.abort(hog)
        assert _drain(first) == cold("paged", "bfloat16", LONG, 20)
        assert _drain(warm) == cold("paged", "bfloat16", PRE + TAILS["q2"])
        _assert_unpinned(eng)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_abort_between_match_and_insert(cold, layout):
    """A request aborted right after its match (before its funding or
    fetch, long before the insert) ends, and leaves no pin, no slot and
    no page of its own behind."""
    eng = _engine(layout, prefix_cache_slots=2)
    try:
        _greedy(eng, PRE + TAILS["q1"])
        match, target = eng._prefix.match, {}

        def match_then_abort(ids, hint=None):
            m = match(ids, hint)
            if target.get("req") is not None and ids == target["req"].prompt_ids:
                eng.abort(target.pop("req"))
            return m

        eng._prefix.match = match_then_abort
        with eng.hold_admissions():
            target["req"] = req = eng.submit(PRE + TAILS["q2"],
                                             SamplingParams(temperature=0.0, max_tokens=40))
        assert len(_drain(req)) < 40 and req.cancelled
        stats = _assert_unpinned(eng)
        assert stats["prefix_cache_hits"] == 1
        assert _greedy(eng, PRE + TAILS["q3"]) == cold(layout, "bfloat16", PRE + TAILS["q3"])
        _assert_unpinned(eng)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shutdown_releases_slots_pages_and_pins(layout):
    eng = _engine(layout, prefix_cache_slots=2)
    _greedy(eng, PRE + TAILS["q1"])
    long_run = SamplingParams(temperature=0.0, max_tokens=90)
    reqs = [eng.submit(PRE + TAILS["q2"], long_run), eng.submit(LONG, long_run)]
    for req in reqs:
        assert req.out_queue.get(timeout=120) is not None  # decoding
    assert eng.shutdown()
    for req in reqs:
        _drain(req)  # every stream ended
    assert not eng._slot_req and sorted(eng._free_slots) == list(range(eng.num_slots))
    with eng._prefix._lock:
        assert eng._prefix._entries and all(e.refs == 0 for e in eng._prefix._entries)
    if layout == "paged":
        assert eng.stats()["pages_in_use"] == entry_pages(eng)


def _pages_snapshot(eng, pages):
    return [{key: t[pages].clone() for key, t in c.items()} for c in eng._cache]


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
def test_donated_pages_are_bitwise_unchanged_under_runahead(cold, kv):
    """decode_runahead 4, decode_block 4, budgets that run out mid-block:
    the pages the donor gave its entry hold the same bits after the
    donor's long decode and a warm reader's, whose prefill skipped them
    (a skipped chunk writes the scratch page)."""
    eng = _engine("paged", kv, prefix_cache_slots=2, decode_runahead=4, decode_block=4)
    try:
        insert, snap = eng._insert_prefixes, {}

        def insert_and_snapshot(reqs):
            insert(reqs)
            if "pages" not in snap and eng._prefix._entries:
                snap["pages"] = list(eng._prefix._entries[0].pages)
                snap["rows"] = _pages_snapshot(eng, snap["pages"])

        eng._insert_prefixes = insert_and_snapshot
        donor = _greedy(eng, PRE + TAILS["q1"], n=30)
        reader = _greedy(eng, PRE + TAILS["q2"], n=23)
        assert len(snap["pages"]) == 32 // 8 and eng.stats()["prefix_cache_hits"] == 1
        _assert_unpinned(eng)
        after = _pages_snapshot(eng, snap["pages"])
        for before_layer, after_layer in zip(snap["rows"], after):
            for key in before_layer:
                assert torch.equal(before_layer[key], after_layer[key]), key
        assert donor == cold("paged", kv, PRE + TAILS["q1"], 30)
        assert reader == cold("paged", kv, PRE + TAILS["q2"], 23)
    finally:
        assert eng.shutdown()


def _first_rows(strip, key, n, quantized):
    """Rows [0, n) of one slot's strip: token-major [S, Hkv, Dh], or int8
    head-major [Hkv, S, Dh] with scales [Hkv, 1, S]."""
    if not quantized:
        return strip[:n]
    return strip[:, :, :n] if key in ("ks", "vs") else strip[:, :n]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_skipped_chunks_leave_the_fetched_rows_alone(kv):
    """Fixed layout: a warm row's chunks below its cached length write back
    what they read, so after its prefill the slot's first rows are still
    bitwise the store's."""
    eng = _engine("fixed", kv, prefix_cache_slots=2)
    try:
        _greedy(eng, PRE + TAILS["q1"])
        chunked, seen = eng._prefill_chunked, []

        def check_after(tokens, lengths, slots, cached=None):
            out = chunked(tokens, lengths, slots, cached)
            if cached is not None and cached.max() > 0:
                slot, n = int(slots[0]), int(cached[0])
                (entry,) = eng._prefix._entries
                for s, c in zip(eng._prefix_store, eng._cache):
                    for key in c:
                        q = "ks" in c
                        seen.append(torch.equal(_first_rows(c[key][slot], key, n, q),
                                                _first_rows(s[key][entry.store_slot], key, n, q)))
            return out

        eng._prefill_chunked = check_after
        _greedy(eng, PRE + TAILS["q2"])
        assert seen and all(seen)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_warm_row_runs_its_cached_chunks_with_no_valid_token(cold, layout, monkeypatch):
    """In a wave with a cold long row the loop starts at chunk 0, and the
    warm row rides every chunk below its cached length with valid = 0:
    on the paged layout its writes go to the scratch page, on the fixed
    layout they write back what they read, so the shared or fetched rows
    are never rewritten (recomputed rows would carry the same bits, so
    only the dispatch shows it)."""
    from generativeaiexamples_tpu_torch.engine import llm_engine

    eng = _engine(layout, prefix_cache_slots=2)
    name = "extend_layers_paged" if layout == "paged" else "extend_layers"
    orig, calls = getattr(llm_engine.llama, name), []

    def recording(params, cfg, tokens, offsets, valid, slots, *args, **kwargs):
        calls.append((offsets.tolist(), valid.tolist(), slots.tolist()))
        return orig(params, cfg, tokens, offsets, valid, slots, *args, **kwargs)

    try:
        _greedy(eng, PRE + TAILS["q1"])
        monkeypatch.setattr(llm_engine.llama, name, recording)
        greedy = SamplingParams(temperature=0.0, max_tokens=6)
        with eng.hold_admissions():
            warm, long_row = eng.submit(PRE + TAILS["q2"], greedy), eng.submit(LONG, greedy)
        got = [_drain(warm), _drain(long_row)]
        monkeypatch.undo()
        # rows in claim order: the warm one, then the long one
        assert [offsets[0] for offsets, _, _ in calls] == [0, 16, 32]
        assert [valid for _, valid, _ in calls] == [[0, 16], [0, 16], [36 - 32, 41 - 32]]
        assert got == [cold(layout, "bfloat16", PRE + TAILS["q2"]), cold(layout, "bfloat16", LONG)]
    finally:
        monkeypatch.undo()
        assert eng.shutdown()


def test_fixed_insert_is_ordered_after_the_fetch_that_reads_its_slot(cold):
    """One store slot. A wave holds a warm row, whose fetch reads the slot,
    and a new preamble, whose insert evicts the entry and rewrites that
    slot after the wave: the warm row streams its cold reference, and the
    new entry serves the next request."""
    eng = _engine("fixed", prefix_cache_slots=1)
    try:
        _greedy(eng, PRE + TAILS["q1"])
        greedy = SamplingParams(temperature=0.0, max_tokens=6)
        with eng.hold_admissions():
            warm = eng.submit(PRE + TAILS["q2"], greedy)
            new = eng.submit(OTHER + TAILS["q2"], greedy)
        assert _drain(warm) == cold("fixed", "bfloat16", PRE + TAILS["q2"])
        assert _drain(new) == cold("fixed", "bfloat16", OTHER + TAILS["q2"])
        stats = _assert_unpinned(eng)
        assert stats["prefix_cache_evictions"] == 1 and stats["prefix_copy_dispatches"] == 3
        assert _greedy(eng, OTHER + TAILS["q3"]) == cold("fixed", "bfloat16", OTHER + TAILS["q3"])
        assert eng.stats()["prefix_cache_hits"] == 2
    finally:
        assert eng.shutdown()


def test_a_pinned_store_slot_is_never_rewritten(cold):
    """While a match pins the only entry, another preamble's insert is
    skipped: the store's rows keep their bits and the entry stays."""
    eng = _engine("fixed", prefix_cache_slots=1)
    try:
        _greedy(eng, PRE + TAILS["q1"])
        entry, _ = eng._prefix.match(PRE + TAILS["q2"])  # pinned by the test
        before = [{k: t.clone() for k, t in c.items()} for c in eng._prefix_store]
        assert _greedy(eng, OTHER + TAILS["q2"]) == cold("fixed", "bfloat16", OTHER + TAILS["q2"])
        _settle(eng)
        assert eng._prefix._entries == [entry] and eng.stats()["prefix_cache_evictions"] == 0
        for b, c in zip(before, eng._prefix_store):
            assert all(torch.equal(b[k], c[k]) for k in c)
        eng._prefix.release(entry)
        _assert_unpinned(eng)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_dispatch_thread_never_reads_the_device_back(cold, layout, monkeypatch):
    """Matching, funding, the fetch and the insert are host work or device
    copies: with warm and cold rows in flight no read-back (``cpu``,
    ``tolist``, ``item``, ``numpy``) or synchronize runs on the dispatch
    thread."""
    eng = _engine(layout, prefix_cache_slots=2, decode_runahead=4)
    seen = set()

    def recording(name):
        original = getattr(torch.Tensor, name)

        def wrapper(self, *args, **kwargs):
            seen.add(threading.current_thread().name)
            return original(self, *args, **kwargs)
        return wrapper

    try:
        for name in ("cpu", "tolist", "item", "numpy"):
            monkeypatch.setattr(torch.Tensor, name, recording(name))
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: seen.add(threading.current_thread().name))
        greedy = SamplingParams(temperature=0.0, max_tokens=8)
        outs = [_drain(eng.submit(PRE + TAILS["q1"], greedy))]
        queues = [eng.submit(p, greedy) for p in (PRE + TAILS["q2"], LONG, SHORT)]
        outs += [_drain(q) for q in queues]
        _settle(eng)
        monkeypatch.undo()
        assert "torch-llm-engine" not in seen and "torch-llm-reader" in seen
        assert eng.stats()["prefix_cache_hits"] == 1
        prompts = [PRE + TAILS["q1"], PRE + TAILS["q2"], LONG, SHORT]
        assert outs == [cold(layout, "bfloat16", p, 8) for p in prompts]
    finally:
        monkeypatch.undo()
        assert eng.shutdown()


# --------------------------------------------------------------------------- #
# Config and backend


_JAX_TINY = dict(model_config_name="debug", max_batch_size=2, max_seq_len=64, prefill_chunk=16,
                 tensor_parallelism=1)


@pytest.mark.parametrize("field,value", [("prefix_cache_enable", "banana"),
                                         ("prefix_cache_enable", "on"),
                                         ("prefix_cache_slots", -1)])
def test_engine_config_refuses_with_the_jax_message(field, value):
    with pytest.raises(ValueError) as want:
        JaxEngine(JaxEngineConfig(**{field: value}, **_JAX_TINY))
    with pytest.raises(ValueError) as got:
        EngineConfig(**{field: value}).validate()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=field):
        LLMEngine(EngineConfig(**dict(TINY, **{field: value})), device="cpu")


@pytest.mark.parametrize("name,value", [("APP_ENGINE_PREFIXCACHEENABLE", "bogus"),
                                        ("APP_ENGINE_PREFIXCACHESLOTS", "-1")])
def test_make_server_refuses_what_jax_refuses(env, name, value):  # noqa: F811 - the fixture
    env.setenv(name, value)
    with pytest.raises(ValueError) as want:
        jvalidate(jget_config())
    with pytest.raises(ValueError) as got:
        _port_starts()
    assert str(got.value) == str(want.value)


def test_from_env_reads_the_prefix_cache_variables():
    cfg = EngineConfig.from_env({"APP_ENGINE_PREFIXCACHEENABLE": "off",
                                 "APP_ENGINE_PREFIXCACHESLOTS": "8"})
    assert (cfg.prefix_cache_enable, cfg.prefix_cache_slots) == ("off", 8)
    default = EngineConfig.from_env({})
    ref = JaxEngineConfig()
    assert (default.prefix_cache_enable, default.prefix_cache_slots) == (
        ref.prefix_cache_enable, ref.prefix_cache_slots) == ("auto", 4)


def test_the_backend_hands_the_hint_to_submit():
    """``TorchLLMBackend.stream_chat`` passes the chain's hint into the
    request's ``SamplingParams``, and submit bumps the hinted entry."""
    eng = _engine("paged", prefix_cache_slots=2)
    try:
        submitted, touched = [], []
        submit, touch = eng.submit, eng._prefix.touch
        eng.submit = lambda ids, params=None: submitted.append(params) or submit(ids, params)
        eng._prefix.touch = lambda hint: touched.append(hint) or touch(hint)
        backend = TorchLLMBackend(engine=eng)
        text = "".join(backend.stream_chat([("user", "hello")], max_tokens=3,
                                           prefix_hint="simple_rag:chat"))
        assert isinstance(text, str)
        assert [p.prefix_hint for p in submitted] == ["simple_rag:chat"]
        assert touched == ["simple_rag:chat"]
        "".join(backend.stream_chat([("user", "hello")], max_tokens=3))
        assert submitted[-1].prefix_hint is None and touched == ["simple_rag:chat"]
    finally:
        assert eng.shutdown()


# --------------------------------------------------------------------------- #
# Against the JAX engine


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prompt_sequence_matches_the_jax_engine(layout):
    """One prompt sequence (a cold preamble, warm repeats, another
    preamble, an exact repeat, a short prompt) through the JAX engine and
    the port on the same weights: equal streams, and equal hit, miss,
    token-reuse and chunk counts after every request."""
    import jax.numpy as jnp

    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JaxParams
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(TINY, kv_layout=layout, prefix_cache_slots=2)
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, serving_layout="layered", **common))
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(**common), device="cpu", params=params_from_jax(weights))
    keys = ("prefix_cache_hits", "prefix_cache_misses", "prefix_cache_tokens_reused",
            "prefill_chunks")
    try:
        j0 = {k: jax_engine.metrics[k] for k in keys}
        sequence = [PRE + TAILS["q1"], PRE + TAILS["q2"], OTHER + [3, 4], PRE + TAILS["q3"],
                    PRE + TAILS["q3"], OTHER + TAILS["q1"], SHORT, LONG]
        for prompt in sequence:
            want = list(jax_engine.iter_ids(prompt, JaxParams(temperature=0.0, max_tokens=8),
                                            timeout=600))
            got = list(port.iter_ids(prompt, SamplingParams(temperature=0.0, max_tokens=8),
                                     timeout=600))
            assert got == want, prompt
            jm, pm = jax_engine.metrics, port.stats()
            assert {k: pm[k] for k in keys} == {k: jm[k] - j0[k] for k in keys}, prompt
    finally:
        jax_engine.shutdown()
        port.shutdown()
