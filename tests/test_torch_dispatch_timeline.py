"""The port's dispatch timeline (generativeaiexamples_tpu_torch/engine/dispatch_timeline.py)
against the JAX package's (generativeaiexamples_tpu/engine/dispatch_timeline.py).

The same span sequences (drawn from a numpy seed: dispatches of every kind
on two threads, stalls, readbacks, pipeline flushes, rollbacks, compile
markers) at the same clock readings give equal span views, cursors and
``spans_since`` tails, cumulative counters, bubble fractions (which sum to
1 within 1e-3, the 4-digit rounding of each of the four) and Perfetto JSON
(with flight timelines overlaid), and capacity changes evict the same
whole windows. The port's one difference is pinned: spans recorded under
the ``launch`` run kind (an engine on the card) name their run time
``launch_s``, draw no device-estimate track, and the bubble names its
device share a launch share; a profile's kernel spans fill the device
track. Both timelines are reset after each test. Exact comparisons
otherwise: no tolerance applies."""
import threading

import numpy as np
import pytest

from generativeaiexamples_tpu.engine import dispatch_timeline as jdt
from generativeaiexamples_tpu_torch.engine import dispatch_timeline as tdt


@pytest.fixture(autouse=True)
def _reset():
    for mod in (jdt, tdt):
        mod.reset()
        mod.configure(enable=True, capacity=4096)
    yield
    for mod in (jdt, tdt):
        mod.reset()
        mod.configure(enable=True, capacity=4096)


def _drive(mod, seed, monkeypatch, n=300):
    now = {"t": 1_700_000_000.0}
    monkeypatch.setattr(mod.time, "time", lambda: now["t"])
    rng = np.random.default_rng(seed)
    kinds = ("prefill", "prefill_chunk", "decode", "spec", "spec_block")

    def record(i):
        now["t"] += float(rng.uniform(0, 0.01))
        r = int(rng.integers(0, 10))
        if r < 6:
            mod.record_span(
                kinds[int(rng.integers(0, 5))], t_wall=now["t"],
                lock_wait_s=float(rng.uniform(0, 0.001)), run_s=float(rng.uniform(0, 0.02)),
                rows=int(rng.integers(0, 9)), tokens=int(rng.integers(0, 64)),
                steps=int(rng.integers(1, 9)), path=("kernel", None)[int(rng.integers(0, 2))],
                rids=list(range(int(rng.integers(0, 20)))), queued=bool(rng.integers(0, 4)),
            )
        elif r == 6:
            mod.record_stall("handoff_backpressure", float(rng.uniform(0, 0.01)), rids=[i])
        elif r == 7:
            mod.record_readback(("decode", "prefill", "spec")[int(rng.integers(0, 3))],
                                float(rng.uniform(0, 0.005)))
        elif r == 8:
            mod.record_pipeline_flush(float(rng.uniform(0, 0.004)), rows=int(rng.integers(0, 8)))
        else:
            mod.record_rollback(float(rng.uniform(0, 0.002)), rows=2, rids=[i])

    out = []
    for i in range(n):
        # two tier threads, named as the engine's
        name = "torch-llm-prefill-tier" if i % 3 == 0 else "torch-llm-engine"
        t = threading.Thread(target=record, args=(i,), name=name)
        t.start()
        t.join()
        if i % 100 == 99:
            spans, cur = mod.spans_since(max(0, mod.cursor() - 40), limit=30)
            out.append((spans, cur, mod.counters_snapshot(), mod.bubble_snapshot(window_s=1e9)))
    mod.record_compile("decode", 0.5, hot=True)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_span_sequences_give_jax_s_views(seed, monkeypatch):
    want = _drive(jdt, seed, monkeypatch)
    got = _drive(tdt, seed, monkeypatch)
    assert got == want
    for *_, bubble in got:
        parts = ("bubble_device_ratio", "bubble_lock_ratio", "bubble_gap_ratio",
                 "bubble_readback_ratio")
        assert abs(sum(bubble[k] for k in parts) - 1.0) <= 1e-3
    assert tdt.recent_spans(5) == jdt.recent_spans(5)


FLIGHT = [{"request_id": "r1", "trace_id": "ab" * 16, "rids": [1], "started_at": 1_700_000_000.5,
           "timeline": [{"t_s": 0.0, "event": "submit"}, {"t_s": 0.25, "event": "first_token"}]}]


@pytest.mark.parametrize("seed", [3, 4])
def test_perfetto_is_jax_s(seed, monkeypatch):
    _drive(jdt, seed, monkeypatch, n=120)
    _drive(tdt, seed, monkeypatch, n=120)
    want = jdt.perfetto_trace(jdt.spans_since(0, limit=10_000)[0], flight=FLIGHT)
    got = tdt.perfetto_trace(tdt.spans_since(0, limit=10_000)[0], flight=FLIGHT)
    assert got == want


def test_capacity_evicts_whole_windows_as_jax_does(monkeypatch):
    for mod in (jdt, tdt):
        mod.configure(capacity=100)  # rounds up to 128
    _drive(jdt, 5, monkeypatch, n=400)
    _drive(tdt, 5, monkeypatch, n=400)
    assert tdt._CAPACITY == jdt._CAPACITY == 128
    assert tdt.spans_since(0, 10_000) == jdt.spans_since(0, 10_000)
    assert tdt._M_EVICTED.value > 0


def test_launch_spans_are_labelled_as_launch_time(monkeypatch):
    tdt.set_run_kind("launch")
    tdt.record_span("decode", t_wall=100.0, lock_wait_s=0.0, run_s=0.004, rows=8, tokens=64)
    (view,) = tdt.spans_since(0)[0]
    assert view["launch_s"] == 0.004 and "device_est_s" not in view
    assert tdt.bubble_snapshot(window_s=1e12)["bubble_run_kind"] == "launch"
    trace = tdt.perfetto_trace([view])
    assert not any(e.get("pid") == tdt._PID_DEVICE_EST for e in trace["traceEvents"])
    device = [{"name": "int8_matmul_mma_kernel", "ts_us": 5.0, "dur_us": 2.0, "tid": 7}]
    trace = tdt.perfetto_trace([view], device_events=device)
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e.get("name") == "process_name"}
    assert "device (torch.profiler)" in names
    assert any(e.get("name") == "int8_matmul_mma_kernel" and e["tid"] == 7
               for e in trace["traceEvents"])
    with pytest.raises(ValueError):
        tdt.set_run_kind("device")


def test_kill_switch_stops_recording():
    tdt.configure(enable=False)
    tdt.record_span("decode", t_wall=1.0, lock_wait_s=0.0, run_s=0.1)
    tdt.record_readback("decode", 0.1)
    assert tdt.spans_since(0) == ([], 0) and not tdt.enabled()


@pytest.mark.parametrize("field,value", [("dispatch_timeline_enable", "maybe"),
                                         ("dispatch_timeline_capacity", 63)])
def test_validation_messages_are_jax_s(field, value):
    from generativeaiexamples_tpu.config.schema import ObservabilityConfig as JObs
    from generativeaiexamples_tpu_torch.config import ObservabilityConfig as TObs

    with pytest.raises(ValueError) as je:
        jdt.validate_config(JObs(**{field: value}))
    with pytest.raises(ValueError) as te:
        tdt.validate_config(TObs(**{field: value}))
    assert str(te.value) == str(je.value)


def test_env_kill_switch_overrides_the_config(monkeypatch):
    from generativeaiexamples_tpu_torch.config import ObservabilityConfig

    monkeypatch.setenv("GENAI_DISPATCH_TIMELINE", "off")
    tdt.configure_from_config(ObservabilityConfig(dispatch_timeline_enable="on"))
    assert not tdt.enabled()
