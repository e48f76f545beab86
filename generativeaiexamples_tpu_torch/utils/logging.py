"""Logging bootstrap.

Counterpart of generativeaiexamples_tpu/utils/logging.py: the same
``LOGLEVEL`` convention, record format, correlation stamp and log tail.

When tracing is active (``ENABLE_TRACING``), every log record carries a
correlation suffix — ``[trace=<32 hex> req=<flight id>]`` — resolved
from the calling thread's active span and flight-recorder binding, so
engine/server log lines line up with traces and ``/internal/requests``
timelines without grepping timestamps. The trace id comes from the one
shared accessor (``utils.tracing.current_trace_id_hex``, which the metric
exemplars and the flight recorder also read), so the stamp can never
disagree with the exemplars. With tracing off the filter is one boolean
check per record.

The root handler also tees every formatted record into a small
in-memory ring (``recent_lines()``) so the anomaly black box
(``utils/blackbox.py``) can include the log tail in its debug bundles
without touching the filesystem. The entry points configure the root
logger through :func:`configure_root`; :func:`get_logger` does it on
first use, as JAX's does.
"""
import collections
import logging
import os
import threading

_CONFIGURED = False

# Bounded ring of recently formatted log lines, for black-box bundles.
_TAIL_CAPACITY = 200
_TAIL_LOCK = threading.Lock()
_TAIL = collections.deque(maxlen=_TAIL_CAPACITY)  # guarded by _TAIL_LOCK

FORMAT = "%(asctime)s %(levelname)s %(name)s%(corr)s: %(message)s"


class _CorrelationFilter(logging.Filter):
    """Stamps ``record.corr`` with the active trace/request ids (or ''
    when tracing is off / nothing is bound). Imports resolve lazily —
    tracing and the flight recorder both log, so a top-level import
    would cycle."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.corr = ""
        try:
            from generativeaiexamples_tpu_torch.utils.tracing import (
                current_trace_id_hex,
                tracing_enabled,
            )

            if not tracing_enabled():
                return True
            parts = []
            trace_id = current_trace_id_hex()
            if trace_id:
                parts.append(f"trace={trace_id}")
            from generativeaiexamples_tpu_torch.utils import flight_recorder

            rec = flight_recorder.current()
            if rec is not None:
                parts.append(f"req={rec.request_id}")
            if parts:
                record.corr = " [" + " ".join(parts) + "]"
        except Exception:  # noqa: BLE001 - logging must never raise
            pass
        return True


class _TailHandler(logging.Handler):
    """Keeps the newest formatted lines in a bounded in-memory ring (the
    black box reads it via :func:`recent_lines`)."""

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # noqa: BLE001 - logging must never raise
            return
        with _TAIL_LOCK:
            _TAIL.append(line)


def recent_lines(limit: int = _TAIL_CAPACITY) -> list:
    """The newest formatted log lines (oldest first), for debug
    bundles."""
    if limit <= 0:
        return []  # [-0:] would slice the whole ring, not none of it
    with _TAIL_LOCK:
        lines = list(_TAIL)
    return lines[-int(limit):]


def configure_root() -> None:
    """``basicConfig`` at ``LOGLEVEL`` (default INFO) in :data:`FORMAT`,
    the correlation filter on the root's handlers and the tail handler on
    the root; once a process."""
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("LOGLEVEL", "INFO").upper()
    logging.basicConfig(level=level, format=FORMAT)
    # The filter must sit on the handler: filters on loggers don't apply
    # to records propagated from child loggers.
    for handler in logging.getLogger().handlers:
        handler.addFilter(_CorrelationFilter())
    tail = _TailHandler()
    tail.setFormatter(logging.Formatter(FORMAT))
    tail.addFilter(_CorrelationFilter())
    logging.getLogger().addHandler(tail)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """Return a logger under the application namespace."""
    configure_root()
    return logging.getLogger(name)
