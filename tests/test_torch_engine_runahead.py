"""The port's pipelined decode on the CPU (every kernel wrapper runs its plain
version): device-resident slot state, a reader thread that does the one
readback per block, and ``decode_runahead`` blocks in flight between them.
Streams are token-identical at any runahead on both KV layouts, greedy and
seeded, and equal the model-level loop; stops and ``max_tokens`` mid-block
end a stream where runahead 1 ends it; budget-exhausted slots are freed
from host shadows without waiting for the reader; abort and shutdown hold
with blocks in flight; and the dispatch thread never reads the device
back."""
import threading
import time

import pytest
import torch

from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
from generativeaiexamples_tpu_torch.models import sampling
from tests.test_torch_engine import CONFIG, PROMPTS, _drain, reference_stream

LAYOUTS = ["paged", "fixed"]
RUNAHEADS = [1, 2, 4]
SEEDED = SamplingParams(temperature=0.9, top_p=0.8, max_tokens=12, seed=21)
GREEDY = SamplingParams(temperature=0.0, max_tokens=12)


def _engine(layout="paged", runahead=4, **overrides):
    cfg = dict(CONFIG, kv_layout=layout, decode_runahead=runahead, **overrides)
    return LLMEngine(EngineConfig(**cfg), device="cpu")


def _seeded_choose(eng, params):
    """The model-level loop's draw for a seeded row: the port's sampler
    with keys (seed, key position), as the engine keys it."""
    def choose(logits, key_pos):
        keys = sampling.sample_keys(torch.tensor([params.seed]), torch.tensor([key_pos]))
        return int(sampling.sample_tokens(
            logits[:, : eng._sample_vocab], torch.tensor([params.temperature]),
            torch.tensor([params.top_p]), keys,
        )[0])
    return choose


def _settled(eng, timeout=60.0):
    """Wait until no slot is held and every readback was emitted."""
    deadline = time.time() + timeout
    while (eng._slot_req or not eng._readback.empty()) and time.time() < deadline:
        time.sleep(0.01)
    assert not eng._slot_req and eng._readback.empty()
    return eng.stats()


class ReaderGate:
    """Holds the reader thread at its first emission until ``open()``, so
    the dispatch thread runs ahead and fills the readback queue."""

    def __init__(self, eng, every=False):
        self.event = threading.Event()
        self.held = threading.Event()
        emit = eng._emit

        def gated(req, token):
            if every or not self.held.is_set():
                self.held.set()
                assert self.event.wait(60)
            emit(req, token)

        eng._emit = gated

    def open(self):
        self.event.set()


def _wait_for(cond, timeout=60.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.005)
    return cond()


@pytest.mark.parametrize("runahead", RUNAHEADS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_streams_are_token_identical_at_any_runahead(layout, runahead):
    """One batch of the three prompts (monolithic, one chunk, chunked),
    greedy, then the same batch with the middle row seeded and sampled:
    every stream equals the model-level loop's."""
    eng = _engine(layout, runahead)
    try:
        assert eng._paged == (layout == "paged")
        queues = [eng.generate_ids(p, GREEDY) for p in PROMPTS]
        for prompt, q in zip(PROMPTS, queues):
            assert _drain(q) == reference_stream(eng, prompt, 12)
        mixed = [GREEDY, SEEDED, GREEDY]
        queues = [eng.generate_ids(p, sp) for p, sp in zip(PROMPTS, mixed)]
        for prompt, sp, q in zip(PROMPTS, mixed, queues):
            choose = _seeded_choose(eng, sp) if sp is SEEDED else None
            assert _drain(q) == reference_stream(eng, prompt, 12, choose)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stops_mid_block_end_where_runahead_1_ends(layout):
    """A stop id drawn mid-block and ``max_tokens`` reached mid-block end
    each stream exactly where runahead 1 ends it, while later blocks are
    already in flight (the reader is held until the queue is full)."""
    base = _engine(layout, 1)
    try:
        base._stop_ids = set()
        free = _drain(base.generate_ids(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=30)))
        ref_max = _drain(base.generate_ids(PROMPTS[2], SamplingParams(temperature=0.0, max_tokens=6)))
        # a stop drawn inside the second block (tokens 5-8), for the first
        # time, and nowhere in the other stream
        stop = next(t for i, t in enumerate(free) if 5 <= i <= 8 and t not in free[:i] + ref_max)
        base._stop_ids = {stop}
        ref_stop = _drain(base.generate_ids(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=30)))
        assert _drain(base.generate_ids(PROMPTS[2], SamplingParams(temperature=0.0, max_tokens=6))) == ref_max
    finally:
        assert base.shutdown()
    assert ref_stop == free[: free.index(stop)] and len(ref_max) == 6  # a block and 1 past the prefill
    eng = _engine(layout, 4)
    try:
        eng._stop_ids = {stop}
        gate = ReaderGate(eng)
        q_stop = eng.generate_ids(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=30))
        q_max = eng.generate_ids(PROMPTS[2], SamplingParams(temperature=0.0, max_tokens=6))
        assert _wait_for(eng._readback.full)  # blocks in flight behind the held reader
        gate.open()
        assert _drain(q_stop) == ref_stop
        assert _drain(q_max) == ref_max
        _settled(eng)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("runahead", RUNAHEADS)
def test_eager_release_dispatches_exactly_the_budget(runahead):
    """max_tokens 17 at decode_block 8: the prefill's token and 16 decode
    steps, so exactly 2 blocks; the slot is freed from its budget shadow,
    not by a third block waiting for the reader."""
    eng = _engine("paged", runahead, decode_block=8)
    try:
        eng._stop_ids = set()
        out = _drain(eng.generate_ids(PROMPTS[0], SamplingParams(temperature=0.0, max_tokens=17)))
        assert len(out) == 17
        stats = _settled(eng)
        assert stats["decode_blocks"] == 2 and stats["decode_steps"] == 16
        assert stats["pages_in_use"] == 0
    finally:
        assert eng.shutdown()


def test_a_pending_request_takes_a_freed_slot_without_the_reader():
    """One slot, two requests: the first's budget runs out after one block
    and the second is admitted and prefilled while the reader is still
    held at the first token."""
    eng = _engine("paged", 4, max_batch_size=1)
    try:
        eng._stop_ids = set()
        gate = ReaderGate(eng)
        params = SamplingParams(temperature=0.0, max_tokens=5)  # one block of 4
        first = eng.generate_ids(PROMPTS[0], params)
        second = eng.generate_ids(PROMPTS[1], params)
        assert _wait_for(lambda: eng.stats()["prefill_waves"] == 2)
        assert gate.held.is_set() and eng.stats()["tokens_generated"] == 0
        gate.open()
        assert _drain(first) == reference_stream(eng, PROMPTS[0], 5)
        assert _drain(second) == reference_stream(eng, PROMPTS[1], 5)
    finally:
        assert eng.shutdown()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_abort_with_blocks_in_flight_frees_the_slot_and_its_pages(layout):
    eng = _engine(layout, 4)
    try:
        gate = ReaderGate(eng)
        req = eng.submit(PROMPTS[1], SamplingParams(temperature=0.0, max_tokens=100))
        assert _wait_for(eng._readback.full)
        assert eng.abort(req) is True
        assert eng.abort(req) is False  # already aborted
        assert eng.abort(req.rid) is False
        gate.open()
        assert len(_drain(req.out_queue)) < 99
        stats = _settled(eng)
        assert sorted(eng._free_slots) == list(range(eng.num_slots))
        assert not eng._live_dev.any()
        if layout == "paged":
            assert stats["pages_in_use"] == 0 and stats["pages_free"] == stats["pages_capacity"]
        # the engine keeps serving
        assert _drain(eng.generate_ids(PROMPTS[0], GREEDY)) == reference_stream(eng, PROMPTS[0], 12)
    finally:
        assert eng.shutdown()


def _two_stops(streams):
    """(i, j, s1, s2): stop ids that end stream i in its first decode block
    (tokens 1-4) and stream j in its second (tokens 5-8), each the first of
    the two stops its stream draws."""
    for i, a in enumerate(streams):
        for j, b in enumerate(streams):
            if i == j:
                continue
            for ia in range(1, 5):
                for jb in range(5, 9):
                    s1, s2 = a[ia], b[jb]
                    if s1 != s2 and s1 not in a[:ia] + b[: jb + 1] and s2 not in a[: ia + 1] + b[:jb]:
                        return i, j, s1, s2
    raise AssertionError("no pair of stops fits these streams")


def test_shutdown_with_a_full_readback_queue_returns_in_time():
    """Shutdown while the readback queue is full and the reader still has to
    hand a finished slot back under the engine lock: one request stops in
    its first decode block (the reader is held there while blocks fill the
    queue), shutdown starts, and a second request stops in the next block,
    its emission delayed until the dispatch thread has left its loop. The
    end-of-stream item goes into the queue outside the lock, so every thread
    exits within the timeout and both streams end where they stop."""
    prompts = [PROMPTS[0], PROMPTS[2], [256, 9, 8, 7, 6], list(range(100, 112))]
    eng = _engine("paged", 2)
    eng._stop_ids = set()
    params = SamplingParams(temperature=0.0, max_tokens=40)
    free = [_drain(q) for q in [eng.generate_ids(p, params) for p in prompts]]
    i, j, s1, s2 = _two_stops(free)
    eng._stop_ids = {s1, s2}
    held, release = threading.Event(), threading.Event()
    emit = eng._emit

    def gated(req, token):
        if token == s1 and req.rid == first.rid:
            held.set()
            assert release.wait(60)
        elif token == s2 and req.rid == second.rid:
            time.sleep(0.3)  # the dispatch thread reaches its exit meanwhile
        emit(req, token)

    eng._emit = gated
    first, second = eng.submit(prompts[i], params), eng.submit(prompts[j], params)
    assert _wait_for(lambda: held.is_set() and eng._readback.full())
    result = []
    closer = threading.Thread(target=lambda: result.append(eng.shutdown(timeout=30)),
                              name="test-shutdown", daemon=True)
    t0 = time.time()
    closer.start()
    time.sleep(0.2)
    release.set()
    closer.join(60)
    assert result == [True] and time.time() - t0 < 30
    assert not any(t.is_alive() for t in eng._threads)
    assert _drain(first.out_queue, timeout=5) == free[i][: free[i].index(s1)]
    assert _drain(second.out_queue, timeout=5) == free[j][: free[j].index(s2)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_dispatch_thread_never_reads_the_device_back(layout, monkeypatch):
    """Every way PyTorch reads a tensor back to the host (``cpu``,
    ``tolist``, ``item``, ``numpy``) and ``torch.cuda.synchronize`` record
    the calling thread while a batch (greedy and sampled rows, monolithic
    and chunked prefill) decodes: the dispatch thread never appears; the
    reader does."""
    eng = _engine(layout, 4)
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
        mixed = [GREEDY, SEEDED, GREEDY]
        queues = [eng.generate_ids(p, sp) for p, sp in zip(PROMPTS, mixed)]
        streams = [_drain(q) for q in queues]
        _settled(eng)
        monkeypatch.undo()
        assert "torch-llm-engine" not in seen
        assert "torch-llm-reader" in seen
        for prompt, sp, stream in zip(PROMPTS, mixed, streams):
            choose = _seeded_choose(eng, sp) if sp is SEEDED else None
            assert stream == reference_stream(eng, prompt, 12, choose)
    finally:
        monkeypatch.undo()
        assert eng.shutdown()


def test_many_consumers_and_aborts_under_a_short_switch_interval():
    """More consumer threads than cores, a thread switch every 10 µs, half
    of them aborting mid-stream: every stream that runs to its end equals
    the model-level loop's, every aborted one is a prefix of it, and every
    slot and page comes back."""
    import os
    import sys

    eng = _engine("paged", 2)
    n = 2 * (os.cpu_count() or 4) + 2
    params = SamplingParams(temperature=0.0, max_tokens=10)
    refs = [reference_stream(eng, PROMPTS[i % 3], 10) for i in range(3)]
    results, errors = {}, []

    def consume(i):
        try:
            gen = eng.iter_ids(PROMPTS[i % 3], params, timeout=120)
            out = [tok for _, tok in zip(range(3 if i % 2 else 10), gen)]
            gen.close()  # the odd ones leave after 3 tokens: abort
            results[i] = out
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(i,), name=f"consumer-{i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not errors and not any(t.is_alive() for t in threads)
        for i in range(n):
            ref = refs[i % 3]
            assert results[i] == (ref[:3] if i % 2 else ref), i
        stats = _settled(eng)
        assert stats["pages_in_use"] == 0
        assert sorted(eng._free_slots) == list(range(eng.num_slots))
    finally:
        assert eng.shutdown()
