"""Prometheus-compatible metrics registry with trace exemplars.

Counterpart of generativeaiexamples_tpu/utils/metrics.py: a copy of its
registry, rendering and bucket presets, and the port's own process
registry (separate from the JAX package's), whose exemplar trace ids
come from the port's tracer (utils/tracing.py).

The reference stack ships tracing only (OTel → collector → Jaeger,
docs/observability.md); tuning a continuous-batching engine against the
TRT-LLM QPS/p50 target needs latency *distributions* — per-phase
histograms (queue wait, TTFT, per-token latency) are the primary signal
named by the serving surveys (PAPERS.md). This module is the in-repo,
dependency-free metrics layer every hot path instruments onto:

- ``Counter`` / ``Gauge`` / ``Histogram`` families with label sets,
  thread-safe (one lock per child; registration under a registry lock);
- Prometheus text exposition format 0.0.4 rendering (``render()``) and
  OpenMetrics rendering (``render(openmetrics=True)``) — the latter
  carries **exemplars**: each histogram bucket remembers the last
  observation that happened under an active trace, so a p99 bucket in
  Grafana links straight to its trace in Jaeger;
- exemplar trace ids resolve through ``utils.tracing`` —
  ``get_tracer().current_span()`` first, then the thread's attached
  remote context — or can be passed explicitly (``observe(v,
  trace_id=...)``) for observations recorded off-thread (the engine's
  reader thread observes TTFT for a request whose span lives on the
  chain worker thread).

Naming follows Prometheus conventions, enforced for the JAX
registry by ``tools/check_metric_names.py``: snake_case, counters end in ``_total``,
timing histograms end in a unit suffix (``_seconds``/``_bytes``/
``_tokens``).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
    "reset_registry",
    "current_trace_id_hex",
    "CONTENT_TYPE_LATEST",
    "CONTENT_TYPE_OPENMETRICS",
    "DEFAULT_BUCKETS",
    "FAST_SECONDS_BUCKETS",
    "SLOW_SECONDS_BUCKETS",
]

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = "application/openmetrics-text; version=1.0.0; charset=utf-8"

# Latency-oriented default buckets: serving phases span ~100 µs (a cache
# hit) to minutes (a cold XLA compile leaking into a request).
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, float("inf"),
)

# Per-scale presets (PR 16 bucket audit): one default cannot serve both
# a dispatch-lock wait (tens of µs) and an admission-queue wait (tens of
# seconds) — the scales differ by ~100x in each direction, so a family
# on the wrong preset parks its whole p95 in one bucket. Families whose
# observed p95 saturated the top finite bucket (or wasted the bottom
# half) declare one of these instead of hand-rolling tuples.
FAST_SECONDS_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, float("inf"),
)
SLOW_SECONDS_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0, float("inf"),
)

_RESERVED_SUFFIXES = ("_sum", "_count", "_bucket")

# Default for Histogram.observe's trace_id: resolve the active trace from
# the tracer. Pass None explicitly to skip both the exemplar AND the
# tracer lookup (hot paths that carry their own trace context, like the
# engine reader thread, pay nothing when there is none).
_AUTO_TRACE = object()


def current_trace_id_hex() -> Optional[str]:
    """The active trace id (32 hex chars) for exemplar attachment, or
    None when tracing is off / no span or remote context is active.
    Delegates to the one shared accessor in ``utils/tracing.py`` (the
    logging stamp and the flight recorder resolve through the same
    path); kept as a re-export because every instrumented module
    historically imported it from here."""
    from generativeaiexamples_tpu_torch.utils import tracing as tracing_mod

    return tracing_mod.current_trace_id_hex()


def _escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    if isinstance(value, float) and value != value:  # NaN
        return "NaN"
    if float(value).is_integer() and abs(value) < 2**53:
        return str(int(value))
    return repr(float(value))


def _render_labels(labelnames: Sequence[str], labelvalues: Sequence[str],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [
        f'{name}="{_escape_label_value(value)}"'
        for name, value in zip(labelnames, labelvalues)
    ]
    pairs += [f'{name}="{_escape_label_value(value)}"' for name, value in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Exemplar:
    __slots__ = ("trace_id", "value", "timestamp")

    def __init__(self, trace_id: str, value: float, timestamp: float):
        self.trace_id = trace_id
        self.value = value
        self.timestamp = timestamp

    def render(self) -> str:
        # OpenMetrics exemplar syntax: `# {trace_id="…"} value timestamp`
        return (
            f' # {{trace_id="{_escape_label_value(self.trace_id)}"}} '
            f"{_format_value(self.value)} {self.timestamp:.3f}"
        )


class _Child:
    """One label-set instance of a metric family."""

    def __init__(self) -> None:
        self._lock = threading.Lock()


class _CounterChild(_Child):
    def __init__(self) -> None:
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    def __init__(self) -> None:
        super().__init__()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild(_Child):
    def __init__(self, buckets: Sequence[float]) -> None:
        super().__init__()
        self._uppers = tuple(buckets)
        self._counts = [0] * len(self._uppers)
        self._sum = 0.0
        self._count = 0
        self._exemplars: List[Optional[_Exemplar]] = [None] * len(self._uppers)

    def observe(self, value: float, trace_id=_AUTO_TRACE) -> None:
        if trace_id is _AUTO_TRACE:
            trace_id = current_trace_id_hex()
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, upper in enumerate(self._uppers):
                if value <= upper:
                    self._counts[i] += 1
                    if trace_id is not None:
                        self._exemplars[i] = _Exemplar(trace_id, value, time.time())
                    break

    def snapshot(self) -> Tuple[List[int], float, int, List[Optional[_Exemplar]]]:
        """(cumulative bucket counts, sum, count, per-bucket exemplars)."""
        with self._lock:
            cumulative: List[int] = []
            running = 0
            for c in self._counts:
                running += c
                cumulative.append(running)
            return cumulative, self._sum, self._count, list(self._exemplars)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def exemplars(self) -> List[_Exemplar]:
        with self._lock:
            return [e for e in self._exemplars if e is not None]


class _MetricFamily:
    """Base: a named metric with HELP text and 0+ label names; children
    are created on first ``labels(...)`` access."""

    typ = "untyped"
    _child_cls = _Child

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = ()):
        _validate_name(name)
        for label in labelnames:
            _validate_label(label)
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            # Unlabeled families always expose their zero value — a scrape
            # sees the full catalog, not just series that fired already.
            self._children[()] = self._make_child()

    def _make_child(self):
        return self._child_cls()

    def labels(self, *labelvalues, **labelkwargs):
        if labelvalues and labelkwargs:
            raise ValueError("pass labels positionally or by name, not both")
        if labelkwargs:
            if set(labelkwargs) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected labels {self.labelnames}, "
                    f"got {tuple(labelkwargs)}"
                )
            values = tuple(str(labelkwargs[n]) for n in self.labelnames)
        else:
            if len(labelvalues) != len(self.labelnames):
                raise ValueError(
                    f"{self.name}: expected {len(self.labelnames)} label "
                    f"values, got {len(labelvalues)}"
                )
            values = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    def _items(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    # -- delegation for unlabeled families ------------------------------
    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; use .labels(...)"
            )
        return self._children[()]


class Counter(_MetricFamily):
    typ = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value

    def total(self) -> float:
        """Sum across every label set (legacy JSON view helper)."""
        return sum(child.value for _, child in self._items())


class Gauge(_MetricFamily):
    typ = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_MetricFamily):
    typ = "histogram"

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        uppers = [float(b) for b in buckets]
        if uppers != sorted(uppers) or len(set(uppers)) != len(uppers):
            raise ValueError(f"{name}: buckets must be strictly increasing")
        if not uppers or uppers[-1] != math.inf:
            uppers.append(math.inf)
        self._buckets = tuple(uppers)
        super().__init__(name, documentation, labelnames)

    def _make_child(self):
        return _HistogramChild(self._buckets)

    def observe(self, value: float, trace_id=_AUTO_TRACE) -> None:
        self._default().observe(value, trace_id=trace_id)

    @property
    def sum(self) -> float:
        return self._default().sum

    @property
    def count(self) -> int:
        return self._default().count

    def total_sum(self) -> float:
        return sum(child.sum for _, child in self._items())

    def total_count(self) -> int:
        return sum(child.count for _, child in self._items())

    def exemplars(self) -> List[_Exemplar]:
        out: List[_Exemplar] = []
        for _, child in self._items():
            out.extend(child.exemplars())
        return out


def _validate_name(name: str) -> None:
    import re

    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"invalid metric name {name!r} (want snake_case)")
    if name.endswith(_RESERVED_SUFFIXES):
        raise ValueError(f"metric name {name!r} ends in a reserved suffix")


def _validate_label(label: str) -> None:
    import re

    if not re.fullmatch(r"[a-z][a-z0-9_]*", label):
        raise ValueError(f"invalid label name {label!r} (want snake_case)")
    if label == "le":
        raise ValueError("label name 'le' is reserved for histogram buckets")


class MetricsRegistry:
    """Thread-safe collection of metric families with exposition-format
    rendering. ``counter``/``gauge``/``histogram`` are get-or-create —
    module-level instrumentation can re-run (test re-imports, multiple
    engine instances) without double-registration errors; a re-register
    with a different type or label set is a bug and raises."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _MetricFamily] = {}

    def _get_or_create(self, cls, name: str, documentation: str,
                       labelnames: Sequence[str], **kwargs):
        with self._lock:
            existing = self._families.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.typ} with labels {existing.labelnames}"
                    )
                return existing
            family = cls(name, documentation, labelnames, **kwargs)
            self._families[name] = family
            return family

    def counter(self, name: str, documentation: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, documentation, labelnames)

    def gauge(self, name: str, documentation: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, documentation, labelnames)

    def histogram(self, name: str, documentation: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(
            Histogram, name, documentation, labelnames, buckets=buckets
        )

    def families(self) -> List[_MetricFamily]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Optional[_MetricFamily]:
        with self._lock:
            return self._families.get(name)

    # -- rendering -------------------------------------------------------
    def render(self, openmetrics: bool = False) -> str:
        """Text exposition: Prometheus 0.0.4 by default; OpenMetrics (with
        per-bucket trace exemplars and the ``# EOF`` terminator) when
        ``openmetrics=True``.

        OpenMetrics counter naming: the FAMILY name must not carry the
        ``_total`` suffix — only the counter's sample line appends it
        (OpenMetrics 1.0 §counter; strict parsers like promtool reject
        ``# TYPE foo_total counter``). The 0.0.4 format has no such
        rule, so its HELP/TYPE lines keep the full sample name.
        """
        lines: List[str] = []
        for family in self.families():
            header = family.name
            if (
                openmetrics
                and family.typ == "counter"
                and header.endswith("_total")
            ):
                header = header[: -len("_total")]
            lines.append(f"# HELP {header} {_escape_help(family.documentation)}")
            lines.append(f"# TYPE {header} {family.typ}")
            if isinstance(family, Histogram):
                self._render_histogram(family, lines, openmetrics)
            else:
                for values, child in family._items():
                    labels = _render_labels(family.labelnames, values)
                    lines.append(
                        f"{family.name}{labels} {_format_value(child.value)}"
                    )
        body = "\n".join(lines)
        if openmetrics:
            return body + ("\n# EOF\n" if body else "# EOF\n")
        return body + "\n" if body else ""

    @staticmethod
    def _render_histogram(family: "Histogram", lines: List[str],
                          openmetrics: bool) -> None:
        for values, child in family._items():
            cumulative, total, count, exemplars = child.snapshot()
            for upper, cum, exemplar in zip(family._buckets, cumulative, exemplars):
                labels = _render_labels(
                    family.labelnames, values, (("le", _format_value(upper)),)
                )
                line = f"{family.name}_bucket{labels} {cum}"
                if openmetrics and exemplar is not None:
                    line += exemplar.render()
                lines.append(line)
            labels = _render_labels(family.labelnames, values)
            lines.append(f"{family.name}_sum{labels} {_format_value(total)}")
            lines.append(f"{family.name}_count{labels} {count}")

    # -- JSON view -------------------------------------------------------
    def collect(self) -> Dict[str, dict]:
        """Structured snapshot for the ``/internal/metrics`` JSON view."""
        out: Dict[str, dict] = {}
        for family in self.families():
            entry: Dict[str, object] = {"type": family.typ, "help": family.documentation}
            series = []
            for values, child in family._items():
                labels = dict(zip(family.labelnames, values))
                if isinstance(family, Histogram):
                    cumulative, total, count, _ = child.snapshot()
                    series.append(
                        {"labels": labels, "sum": total, "count": count,
                         "buckets": dict(zip(
                             (_format_value(u) for u in family._buckets),
                             cumulative,
                         ))}
                    )
                else:
                    series.append({"labels": labels, "value": child.value})
            entry["series"] = series
            out[family.name] = entry
        return out


# --------------------------------------------------------------------------- #
# Process-wide registry

_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """Process-wide default registry (every layer instruments onto it)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = MetricsRegistry()
        return _REGISTRY


def set_registry(registry: MetricsRegistry) -> None:
    """Testing hook — swap the process registry."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = registry


def reset_registry() -> None:
    """Testing hook — drop the registry; the NEXT get_registry() call
    creates a fresh one, but families cached at module level by
    instrumented layers keep pointing at the old one. Prefer reading
    deltas in tests over resetting."""
    set_registry(None)  # type: ignore[arg-type]
