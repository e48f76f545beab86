"""The port's logging bootstrap (generativeaiexamples_tpu_torch/utils/logging.py)
against the JAX package's (generativeaiexamples_tpu/utils/logging.py), on the
CPU: the correlation stamp (``[trace=<32 hex> req=<flight id>]``) for a
thread with an attached trace context and a bound flight record, with only
one of them, and with tracing off; the tail ring's lines and limits for the
same records; the record format. Each package's tracer and flight recorder
are put back after each test. Exact comparisons: no tolerance applies."""
import logging

import pytest

from generativeaiexamples_tpu.utils import flight_recorder as jfr
from generativeaiexamples_tpu.utils import logging as jlog
from generativeaiexamples_tpu.utils import tracing as jtracing
from generativeaiexamples_tpu_torch.utils import flight_recorder as tfr
from generativeaiexamples_tpu_torch.utils import logging as tlog
from generativeaiexamples_tpu_torch.utils import tracing as ttracing

PACKAGES = ((jlog, jtracing, jfr), (tlog, ttracing, tfr))
TRACE, SPAN = 0x4BF92F3577B34DA6A3CE929D0E0E4736, 0x00F067AA0BA902B7


def _record(msg="hello %s", args=("there",), created=1_700_000_000.125):
    rec = logging.makeLogRecord({"name": "genai.test", "levelno": logging.WARNING,
                                 "levelname": "WARNING", "msg": msg, "args": args})
    rec.created, rec.msecs = created, 125.0
    return rec


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for _, tracing, fr in PACKAGES:
        fr.reset()
        tracing.reset_tracer()
    yield monkeypatch
    for _, tracing, fr in PACKAGES:
        fr.unbind()
        tracing.get_tracer().attach_context(None)
        fr.reset()
        tracing.reset_tracer()


def _stamp(log_mod, tracing, fr, trace: bool, record: bool) -> str:
    tracer = tracing.get_tracer()
    tracer.attach_context(tracing.SpanContext(TRACE, SPAN) if trace else None)
    rec = fr.start(trace_id=f"{TRACE:032x}", request_id="req-0001") if record else None
    fr.bind(rec)
    try:
        out = _record()
        assert log_mod._CorrelationFilter().filter(out) is True
        return out.corr
    finally:
        fr.unbind()
        tracer.attach_context(None)


@pytest.mark.parametrize("trace,record", [(True, True), (True, False), (False, True),
                                          (False, False)])
@pytest.mark.parametrize("enabled", ["true", ""])
def test_correlation_stamp_matches_jax(_reset, trace, record, enabled):
    _reset.setenv("ENABLE_TRACING", enabled)
    _reset.setenv("TRACE_EXPORTER", "memory")
    stamps = [_stamp(*pkg, trace, record) for pkg in PACKAGES]
    assert stamps[1] == stamps[0]
    if enabled and trace and record:
        assert stamps[1] == f" [trace={TRACE:032x} req=req-0001]"
    if not enabled:
        assert stamps[1] == ""


def test_correlation_stamp_of_an_open_span_matches_jax(_reset):
    _reset.setenv("ENABLE_TRACING", "true")
    _reset.setenv("TRACE_EXPORTER", "memory")
    stamps = []
    for log_mod, tracing, fr in PACKAGES:
        with tracing.get_tracer().span("op") as span:
            out = _record()
            log_mod._CorrelationFilter().filter(out)
            stamps.append(out.corr.replace(f"{span.context.trace_id:032x}", "<trace>"))
    assert stamps[1] == stamps[0] == " [trace=<trace>]"


def test_tail_lines_and_limits_match_jax():
    fmt = "%(asctime)s %(levelname)s %(name)s%(corr)s: %(message)s"
    assert tlog.FORMAT == fmt
    tails = []
    for log_mod, _, _ in PACKAGES:
        handler = log_mod._TailHandler()
        handler.setFormatter(logging.Formatter(fmt))
        handler.addFilter(log_mod._CorrelationFilter())
        with log_mod._TAIL_LOCK:
            saved = list(log_mod._TAIL)
            log_mod._TAIL.clear()
        try:
            for i in range(log_mod._TAIL_CAPACITY + 7):
                handler.handle(_record("line %d", (i,), created=1_700_000_000.0 + i))
            tails.append([log_mod.recent_lines(n) for n in (0, -1, 1, 5, 500)])
        finally:
            with log_mod._TAIL_LOCK:
                log_mod._TAIL.clear()
                log_mod._TAIL.extend(saved)
    assert tails[1] == tails[0]
    assert tails[1][0] == [] and len(tails[1][4]) == tlog._TAIL_CAPACITY == jlog._TAIL_CAPACITY


def test_get_logger_configures_the_root_once_with_the_tail():
    tlog.get_logger("generativeaiexamples_tpu_torch.router.app").error("routed %d", 3)
    assert any(line.endswith("generativeaiexamples_tpu_torch.router.app: routed 3")
               for line in tlog.recent_lines(5))
    tails = [h for h in logging.getLogger().handlers if isinstance(h, tlog._TailHandler)]
    tlog.configure_root()
    assert len([h for h in logging.getLogger().handlers
                if isinstance(h, tlog._TailHandler)]) == len(tails) == 1
