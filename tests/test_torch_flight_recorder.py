"""The port's flight recorder (generativeaiexamples_tpu_torch/utils/flight_recorder.py)
against the JAX package's (generativeaiexamples_tpu/utils/flight_recorder.py).

``EVENT_CATALOG`` is JAX's, key for key and text for text. The same
operation sequences (drawn from a numpy seed: server- and engine-owned
records, rid mappings, events, finishes, slow thresholds, ring resizes,
in-flight stamps) with both modules' clocks fixed to the same sequence give
equal summaries, timelines, cursors, ``completed_since`` tails, trace
filters, slow captures (the JSONL lines included) and counters. Exact
comparisons: no tolerance applies.

Each test resets only the two recorders (their module state), never the
JAX process registry."""
import itertools
import json

import numpy as np
import pytest

from generativeaiexamples_tpu.utils import flight_recorder as jfr
from generativeaiexamples_tpu_torch.utils import flight_recorder as tfr

KINDS = sorted(jfr.EVENT_CATALOG)


@pytest.fixture(autouse=True)
def _reset():
    for mod in (jfr, tfr):
        mod.reset()
    yield
    for mod in (jfr, tfr):
        mod.reset()


def test_event_catalog_is_jax_s():
    assert tfr.EVENT_CATALOG == jfr.EVENT_CATALOG
    assert list(tfr.EVENT_CATALOG) == list(jfr.EVENT_CATALOG)


def _clock(monkeypatch, mod):
    """Both clocks step by the same fixed increments."""
    ticks = itertools.count()
    monkeypatch.setattr(mod.time, "monotonic", lambda: 100.0 + 0.125 * next(ticks))
    wall = itertools.count()
    monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.0 + 0.5 * next(wall))


def _run(mod, seed, monkeypatch, capture):
    _clock(monkeypatch, mod)
    mod.configure(capacity=6, slow_ttft_ms=250.0, slow_total_ms=900.0, capture_path=capture)
    rng = np.random.default_rng(seed)
    live, rid = [], 0
    out = []
    for step in range(160):
        op = int(rng.integers(0, 9))
        if op <= 1 or not live:
            owner = "server" if rng.integers(0, 2) else "engine"
            trace = f"{int(rng.integers(1, 4)):032x}" if rng.integers(0, 2) else None
            rec = mod.start(trace_id=trace, request_id=f"r{step}", owner=owner)
            live.append(rec)
        elif op == 2:
            rec = live[int(rng.integers(0, len(live)))]
            rid += 1
            mod.map_rid(rid, rec)
        elif op == 3:
            rec = live[int(rng.integers(0, len(live)))]
            rec.event(KINDS[int(rng.integers(0, len(KINDS)))], n=int(rng.integers(0, 9)))
        elif op == 4 and rid:
            mod.event_rid(int(rng.integers(1, rid + 1)), "prefill_chunk", chunk=step)
        elif op == 5 and rid:
            mod.finish_rid(int(rng.integers(1, rid + 1)), "finish")
        elif op == 6:
            rec = live.pop(int(rng.integers(0, len(live))))
            rec.event("first_token")
            mod.finish(rec, "finish" if rng.integers(0, 3) else "abort")
        elif op == 7:
            out.append(("stamped", mod.annotate_inflight("hot_path_compile", step=step)))
        elif op == 8:
            mod.bind(live[-1])
            mod.event("retry", attempt=1)
            out.append(("current", mod.current().request_id))
            mod.unbind()
        if step % 16 == 15:
            out.append(("views", mod.inflight(), mod.recent(4), mod.slow_captures(3),
                        mod.cursor(), mod.completed_since(max(0, mod.cursor() - 3)),
                        mod.completed_since(0, slow=True, limit=2),
                        mod.timelines_for_trace(f"{1:032x}"), mod.recent_timelines(2),
                        mod.get_timeline(f"r{step - 3}"), mod.get_timeline(str(rid))))
        if step == 80:
            mod.configure(capacity=3, slow_capacity=2)
    out.append(("emitted", sorted(mod.emitted_kinds())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_operation_sequences_give_jax_s_views(seed, monkeypatch, tmp_path):
    jcap, tcap = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    want = _run(jfr, seed, monkeypatch, str(jcap))
    got = _run(tfr, seed, monkeypatch, str(tcap))
    assert got == want
    jlines = jcap.read_text().splitlines() if jcap.exists() else []
    tlines = tcap.read_text().splitlines() if tcap.exists() else []
    assert [json.loads(x) for x in tlines] == [json.loads(x) for x in jlines]


def test_event_cap_drops_and_counts_like_jax():
    for mod in (jfr, tfr):
        rec = mod.start(request_id="cap")
        for i in range(mod.EVENT_CAP + 7):
            rec.event("prefill_chunk", chunk=i)
        assert rec.dropped == 7 and len(rec.events) == mod.EVENT_CAP
    assert tfr.EVENT_CAP == jfr.EVENT_CAP


def test_disabled_recorder_is_a_noop():
    tfr.configure(enable=False)
    assert tfr.start() is None and tfr.current() is None
    tfr.event("submit")
    assert tfr.annotate_inflight("abort") == 0 and tfr.inflight() == []


@pytest.mark.parametrize("field,value", [
    ("flight_recorder_enable", "maybe"), ("flight_recorder_capacity", 0),
    ("slow_request_ttft_ms", -1.0), ("slow_request_total_ms", -5.0),
])
def test_validation_messages_are_jax_s(field, value):
    from generativeaiexamples_tpu.config.schema import ObservabilityConfig as JObs
    from generativeaiexamples_tpu_torch.config import ObservabilityConfig as TObs

    with pytest.raises(ValueError) as je:
        jfr.validate_config(JObs(**{field: value}))
    with pytest.raises(ValueError) as te:
        tfr.validate_config(TObs(**{field: value}))
    assert str(te.value) == str(je.value)


def test_slow_capture_path_may_not_be_a_directory(tmp_path):
    from generativeaiexamples_tpu_torch.config import ObservabilityConfig

    with pytest.raises(ValueError, match="not an existing directory"):
        tfr.validate_config(ObservabilityConfig(slow_capture_path=str(tmp_path)))
