"""The port's tracer (generativeaiexamples_tpu_torch/utils/tracing.py) against
the JAX package's (generativeaiexamples_tpu/utils/tracing.py): the same
``traceparent`` parsing and rendering (ids drawn from a numpy seed), the
same span nesting under a remote parent, the same span dictionaries and
OTLP JSON for the same span (ids and clock fixed), the same exporters, and
``ENABLE_TRACING`` gating both alike. The one difference is pinned: at
span end the port attaches the process's resident set size read from
``/proc/self/statm`` and no CPU or machine-memory percentage (the GPU
machine has no psutil). Exact comparisons: no tolerance applies."""
import json
import os

import numpy as np
import pytest

from generativeaiexamples_tpu.utils import tracing as jt
from generativeaiexamples_tpu_torch.utils import tracing as tt


def _headers(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(20):
        tid = int(rng.integers(0, 2**63)) << 64 | int(rng.integers(0, 2**63))
        sid = int(rng.integers(0, 2**63))
        flags = int(rng.integers(0, 4))
        out.append(f"00-{tid:032x}-{sid:016x}-{flags:02x}")
    out += ["", "garbage", "00-" + "0" * 32 + "-00f067aa0ba902b7-01",
            "00-4bf92f3577b34da6a3ce929d0e0e4736-" + "0" * 16 + "-01", "00-zz-yy-01"]
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_traceparent_round_trip_is_jax_s(seed):
    for header in _headers(seed):
        want = jt.SpanContext.from_traceparent(header)
        got = tt.SpanContext.from_traceparent(header)
        assert (got is None) == (want is None), header
        if want is not None:
            assert (got.trace_id, got.span_id, got.sampled) == (
                want.trace_id, want.span_id, want.sampled)
            assert got.to_traceparent() == want.to_traceparent()


def _one_span(mod, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.5)
    exporter = mod.InMemorySpanExporter()
    tracer = mod.Tracer(service_name="chain-server", exporter=exporter, flush_interval=0.05)
    tracer._rng.seed(1234)
    try:
        remote = tracer.extract({"traceparent": "00-4bf92f3577b34da6a3ce929d0e0e4736-"
                                                "00f067aa0ba902b7-01"})
        tracer.attach_context(remote)
        assert mod.current_trace_id_hex() is None  # the NoopTracer is the process one
        with tracer.span("outer", {"k": 1}) as outer:
            with tracer.span("inner") as inner:
                inner.add_event("tok", {"length": 3})
                headers = tracer.inject({})
            outer.set_attribute("hits", 2)
        try:
            with tracer.span("boom"):
                raise RuntimeError("x")
        except RuntimeError:
            pass
        tracer.force_flush()
        spans = list(exporter.spans)
    finally:
        tracer.shutdown()
    return spans, headers


def test_spans_are_jax_s(monkeypatch):
    want, wh = _one_span(jt, monkeypatch)
    got, gh = _one_span(tt, monkeypatch)
    assert gh == wh
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert [tt._otlp_span(s) for s in got] == [jt._otlp_span(s) for s in want]
    inner, outer = got[0], got[1]
    assert inner.parent_id == outer.context.span_id
    assert outer.context.trace_id == 0x4bf92f3577b34da6a3ce929d0e0e4736
    assert got[2].status == "ERROR"


def test_current_trace_id_resolves_the_span_then_the_remote(monkeypatch):
    tracer = tt.Tracer(exporter=tt.InMemorySpanExporter())
    monkeypatch.setattr(tt, "_TRACER", tracer)
    try:
        assert tt.current_trace_id_hex() is None
        ctx = tt.SpanContext(0xABC, 0xDEF)
        tracer.attach_context(ctx)
        assert tt.current_trace_id_hex() == f"{0xABC:032x}"
        with tracer.span("x") as span:
            assert tt.current_trace_id_hex() == f"{span.context.trace_id:032x}"
        tracer.attach_context(None)
        assert tt.current_trace_id_hex() is None
    finally:
        tracer.shutdown()


@pytest.mark.parametrize("value,on", [("true", True), ("1", True), ("yes", True),
                                      ("", False), ("false", False), ("0", False)])
def test_enable_tracing_gates_both_alike(value, on, monkeypatch):
    monkeypatch.setenv("ENABLE_TRACING", value)
    assert tt.tracing_enabled() is jt.tracing_enabled() is on


def test_disabled_tracer_is_a_noop(monkeypatch):
    monkeypatch.delenv("ENABLE_TRACING", raising=False)
    monkeypatch.setattr(tt, "_TRACER", None)
    tracer = tt.get_tracer()
    try:
        assert isinstance(tracer, tt.NoopTracer)
        with tracer.span("x") as span:
            span.set_attribute("a", 1)
        assert tracer.extract({"traceparent": "00-" + "1" * 32 + "-" + "2" * 16 + "-01"}) is None
        assert tracer.inject({}) == {}
    finally:
        monkeypatch.setattr(tt, "_TRACER", None)


def test_jsonl_exporter_writes_jax_s_lines(tmp_path, monkeypatch):
    lines = {}
    for mod in (jt, tt):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_001.0)
        path = tmp_path / f"{mod.__name__}.jsonl"
        monkeypatch.setenv("TRACE_EXPORTER", "jsonl")
        monkeypatch.setenv("TRACE_JSONL_PATH", str(path))
        exporter = mod._exporter_from_env("svc")
        assert isinstance(exporter, mod.JsonlSpanExporter)
        span = mod.Span("s", mod.SpanContext(7, 9), None, 1_700_000_000.0, 1_700_000_000.5)
        exporter.export([span])
        lines[mod] = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[tt] == lines[jt]
    assert lines[tt][0]["trace_id"] == f"{7:032x}"


def test_system_metrics_are_the_process_rss():
    span = tt.Span("s", tt.SpanContext(1, 2), None, 0.0)
    tt._attach_system_metrics(span)
    with open("/proc/self/statm") as fh:
        rss_mb = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    assert set(span.attributes) == {"system.process.memory_rss_mb"}
    assert abs(span.attributes["system.process.memory_rss_mb"] - rss_mb) < 64.0
