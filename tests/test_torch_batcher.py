"""The port's MicroBatcher (generativeaiexamples_tpu_torch/engine/batcher.py)
through the behavioural cases of the JAX package's tests/test_batcher.py:
batch formation at max_batch and max_wait_ms, row-ladder padding, lane
priority, the ingest gate and its preemption by queries, deadlines, result
scatter, errors and close; plus the ladder and validate_config against the
JAX functions themselves (same values, same messages). Host code only:
every comparison is exact."""
import threading
import time
import types

import pytest

from generativeaiexamples_tpu.engine import batcher as jbatcher
from generativeaiexamples_tpu_torch.config import BatchingConfig
from generativeaiexamples_tpu_torch.engine.batcher import (
    LANE_INGEST,
    LANE_QUERY,
    MicroBatcher,
    row_bucket,
    row_ladder,
    validate_config,
)
from generativeaiexamples_tpu_torch.utils import resilience


class _Recorder:
    """Dispatch fn capturing (payloads, pad_rows) per call."""

    def __init__(self, fn=lambda p: p, delay: float = 0.0):
        self.calls = []
        self.lock = threading.Lock()
        self._fn = fn
        self._delay = delay

    def __call__(self, payloads, pad_rows):
        with self.lock:
            self.calls.append((list(payloads), pad_rows))
        if self._delay:
            time.sleep(self._delay)
        return [self._fn(p) for p in payloads]


@pytest.fixture
def make():
    """Batchers built by a test, closed after it."""
    made = []

    def build(*args, **kwargs):
        b = MicroBatcher(*args, **kwargs)
        made.append(b)
        return b

    yield build
    for b in made:
        b.close()


# --------------------------------------------------------------------------- #
# ladder and config


@pytest.mark.parametrize("max_batch", [1, 2, 3, 8, 16, 24, 32, 33])
def test_row_ladder_and_bucket_equal_jax(max_batch):
    assert row_ladder(max_batch) == jbatcher.row_ladder(max_batch)
    for n in range(1, 2 * max_batch + 2):
        assert row_bucket(n, max_batch) == jbatcher.row_bucket(n, max_batch)


def test_row_ladder_values():
    assert row_ladder(32) == (1, 2, 4, 8, 16, 32)
    assert row_ladder(24) == (1, 2, 4, 8, 16, 24)
    assert row_bucket(3, 32) == 4 and row_bucket(99, 32) == 32


def test_batching_defaults_equal_jax_and_validate():
    from generativeaiexamples_tpu.config import AppConfig

    ref = AppConfig.from_dict({}).batching
    mine = BatchingConfig()
    for field in ("enable", "max_wait_ms", "max_batch_embed", "max_batch_rerank",
                  "ingest_decode_yield_ms"):
        assert getattr(mine, field) == getattr(ref, field), field
    validate_config(mine)
    validate_config(types.SimpleNamespace(batching=mine))


@pytest.mark.parametrize("field,value", [
    ("enable", "maybe"), ("max_wait_ms", -1), ("max_batch_embed", 0),
    ("max_batch_rerank", 0), ("ingest_decode_yield_ms", -5),
])
def test_validate_config_messages_equal_jax(field, value):
    bad = types.SimpleNamespace(**{**BatchingConfig().__dict__, field: value})
    with pytest.raises(ValueError) as want:
        jbatcher.validate_config(bad)
    with pytest.raises(ValueError) as got:
        validate_config(bad)
    assert str(got.value) == str(want.value)
    assert f"batching.{field}" in str(got.value)


# --------------------------------------------------------------------------- #
# batch formation


def test_full_batch_dispatches_in_one_call(make):
    rec = _Recorder()
    b = make("t", rec, max_batch=4, max_wait_ms=10_000)
    items = b.submit_many(list(range(4)))
    assert [it.get(timeout=10) for it in items] == [0, 1, 2, 3]
    assert rec.calls == [([0, 1, 2, 3], 4)]


def test_max_wait_flushes_partial_batch(make):
    rec = _Recorder()
    b = make("t", rec, max_batch=64, max_wait_ms=30)
    t0 = time.monotonic()
    items = b.submit_many([10, 11, 12])
    assert [it.get(timeout=10) for it in items] == [10, 11, 12]
    assert len(rec.calls) == 1  # coalesced despite never filling
    assert time.monotonic() - t0 < 5.0  # flushed by the window, not a stall


@pytest.mark.parametrize("n,rung", [(1, 1), (3, 4), (5, 8), (8, 8)])
def test_row_ladder_padding_passed_to_dispatch(make, n, rung):
    rec = _Recorder()
    b = make("t", rec, max_batch=8, max_wait_ms=20)
    [it.get(timeout=10) for it in b.submit_many(list(range(n)))]
    assert rec.calls == [(list(range(n)), rung)]


def test_oversize_submission_splits_at_max_batch(make):
    rec = _Recorder()
    b = make("t", rec, max_batch=4, max_wait_ms=20)
    items = b.submit_many(list(range(10)))
    assert [it.get(timeout=10) for it in items] == list(range(10))
    sizes = sorted(len(c[0]) for c in rec.calls)
    assert sum(sizes) == 10 and max(sizes) <= 4
    assert b.counters["query_dispatches"] == len(rec.calls)
    assert b.counters["query_rows"] == 10


def test_unknown_lane_raises(make):
    b = make("t", _Recorder())
    with pytest.raises(ValueError, match="unknown lane"):
        b.submit("x", lane="bulk")


@pytest.mark.parametrize("kwargs,match", [
    ({"max_batch": 0}, "max_batch must be >= 1"), ({"max_wait_ms": -1}, "max_wait_ms must be >= 0"),
])
def test_constructor_checks(kwargs, match):
    with pytest.raises(ValueError, match=match):
        MicroBatcher("t", _Recorder(), **kwargs)


# --------------------------------------------------------------------------- #
# priority lanes and the ingest gate


def test_query_lane_dispatches_before_queued_ingest_backlog(make):
    order = []
    lock = threading.Lock()

    def dispatch(payloads, pad_rows):
        with lock:
            order.append(list(payloads))
        return payloads

    b = make("t", dispatch, max_batch=4, max_wait_ms=5)
    with b.hold():
        bulk = [b.submit(("ingest", i), lane=LANE_INGEST) for i in range(12)]
        q = b.submit(("query", 0), lane=LANE_QUERY)
    q.get(timeout=10)
    for it in bulk:
        it.get(timeout=10)
    assert order[0] == [("query", 0)]  # interactive never queues behind bulk


def test_ingest_gate_runs_only_for_ingest_lane(make):
    gate_calls = []

    def gate(timeout_s):
        gate_calls.append(timeout_s)
        return True  # decode idle

    b = make("t", _Recorder(), max_batch=4, max_wait_ms=5, ingest_gate=gate)
    b.submit("q", lane=LANE_QUERY).get(timeout=10)
    assert not gate_calls  # the query lane never yields to decode
    b.submit("d", lane=LANE_INGEST).get(timeout=10)
    assert len(gate_calls) >= 1
    assert b.counters["ingest_gated_batches"] == 0  # the gate was open at once


def test_query_arriving_during_ingest_gate_preempts_bulk_dispatch(make):
    """A query arriving while the bulk batch waits on the gate is served
    first, without waiting out the gate's budget; the bulk batch keeps its
    order and goes once the gate opens."""
    gate_entered = threading.Event()
    decode_idle = threading.Event()
    order = []
    lock = threading.Lock()

    def gate(timeout_s):
        gate_entered.set()
        return decode_idle.wait(timeout_s)  # sliced engine wait

    def dispatch(payloads, pad_rows):
        with lock:
            order.append(list(payloads))
        return payloads

    b = make("t", dispatch, max_batch=4, max_wait_ms=1, ingest_gate=gate, gate_budget_ms=10_000)
    bulk = b.submit_many([("d", i) for i in range(3)], lane=LANE_INGEST)
    assert gate_entered.wait(10)  # the dispatch thread is inside the gate
    q = b.submit(("q", 0), lane=LANE_QUERY)
    assert q.get(timeout=10) == ("q", 0)
    decode_idle.set()
    assert [it.get(timeout=10) for it in bulk] == [("d", i) for i in range(3)]
    assert order[0] == [("q", 0)]
    assert order[1] == [("d", 0), ("d", 1), ("d", 2)]
    assert b.counters["ingest_gated_batches"] >= 1 and b.counters["ingest_gate_wait_s"] > 0


def test_a_closed_gate_delays_ingest_by_its_budget_only(make):
    b = make("t", _Recorder(), max_batch=4, max_wait_ms=1,
             ingest_gate=lambda timeout_s: time.sleep(timeout_s) or False, gate_budget_ms=60)
    t0 = time.monotonic()
    assert b.submit("d", lane=LANE_INGEST).get(timeout=10) == "d"
    assert 0.05 <= time.monotonic() - t0 < 5.0
    assert b.counters["ingest_gated_batches"] == 1


@pytest.mark.parametrize("exc", [RuntimeError("engine gone"), ValueError("bad")])
def test_a_failing_gate_lets_ingest_proceed(make, exc):
    def gate(timeout_s):
        raise exc

    b = make("t", _Recorder(), max_batch=4, max_wait_ms=1, ingest_gate=gate)
    assert b.submit("d", lane=LANE_INGEST).get(timeout=10) == "d"


def test_batcher_thread_is_named_and_daemon(make):
    b = make("embed", _Recorder())
    assert b._thread is None  # starts at the first submit
    b.submit("x").get(timeout=10)
    assert b._thread.name == "batcher-embed" and b._thread.daemon


def test_submit_after_close_raises():
    b = MicroBatcher("t", _Recorder(), max_batch=4, max_wait_ms=5)
    b.submit("x").get(timeout=10)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("y")  # a closed batcher must not silently restart


# --------------------------------------------------------------------------- #
# deadlines


def _submit_with_deadline(b, payload, budget_s):
    resilience.set_current_deadline(resilience.Deadline(budget_s))
    try:
        return b.submit(payload)
    finally:
        resilience.set_current_deadline(None)


def test_deadline_caps_the_batch_wait_window(make):
    b = make("t", _Recorder(), max_batch=64, max_wait_ms=60_000)
    item = _submit_with_deadline(b, "x", 1.0)
    t0 = time.monotonic()
    assert item.get(timeout=30) == "x"
    assert time.monotonic() - t0 < 10.0  # flushed by the 1 s deadline, not the 60 s window


def test_expired_deadline_fails_item_without_dispatch(make):
    rec = _Recorder()
    b = make("t", rec, max_batch=64, max_wait_ms=10)
    item = _submit_with_deadline(b, "x", 0.0)
    with pytest.raises(resilience.DeadlineExceeded):
        item.get(timeout=10)
    assert rec.calls == []  # no device work for a dead request


def test_undeadlined_items_are_untouched_by_peers_deadline(make):
    rec = _Recorder()
    b = make("t", rec, max_batch=64, max_wait_ms=50)
    with b.hold():
        free = b.submit("free")
        dead = _submit_with_deadline(b, "dead", 0.0)
    assert free.get(timeout=10) == "free"
    with pytest.raises(resilience.DeadlineExceeded):
        dead.get(timeout=10)
    assert ["free"] in [c[0] for c in rec.calls]


# --------------------------------------------------------------------------- #
# scatter and errors


def test_result_scatter_under_concurrent_submission(make):
    b = make("t", _Recorder(fn=lambda p: p * 7), max_batch=8, max_wait_ms=3)
    results = {}
    lock = threading.Lock()

    def worker(i):
        out = b.submit(i).get(timeout=10)
        with lock:
            results[i] = out

    threads = [threading.Thread(target=worker, args=(i,), name=f"t{i}", daemon=True)
               for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert results == {i: i * 7 for i in range(24)}


def test_dispatch_error_propagates_to_every_item_in_batch(make):
    def dispatch(payloads, pad_rows):
        raise RuntimeError("device exploded")

    b = make("t", dispatch, max_batch=4, max_wait_ms=5)
    for it in b.submit_many([1, 2, 3]):
        with pytest.raises(RuntimeError, match="device exploded"):
            it.get(timeout=10)
    # the thread survives and keeps dispatching
    with pytest.raises(RuntimeError, match="device exploded"):
        b.submit(9).get(timeout=10)


def test_a_short_result_list_fails_the_batch(make):
    b = make("t", lambda payloads, pad_rows: payloads[:-1], max_batch=4, max_wait_ms=5)
    for it in b.submit_many([1, 2]):
        with pytest.raises(RuntimeError, match="returned 1 results for 2"):
            it.get(timeout=10)


def test_close_fails_pending_items():
    rec = _Recorder(delay=0.2)
    b = MicroBatcher("t", rec, max_batch=1, max_wait_ms=0)
    first = b.submit("a")  # occupies the dispatch thread for ~200 ms
    deadline = time.monotonic() + 10
    while not rec.calls and time.monotonic() < deadline:
        time.sleep(0.001)  # wait until the first dispatch is in flight
    with b.hold():
        stuck = b.submit("b")
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        stuck.get(timeout=10)
    first.get(timeout=10)  # the in-flight dispatch still completes
