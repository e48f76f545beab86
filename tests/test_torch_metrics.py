"""The port's metrics registry (generativeaiexamples_tpu_torch/utils/metrics.py)
against the JAX package's (generativeaiexamples_tpu/utils/metrics.py), and
the port's process registry against JAX's family catalog.

Exposition: the same families, label sets and observations (values drawn
from a numpy seed, exemplar trace ids explicit, exemplar clock fixed) render
byte-equal in Prometheus 0.0.4 and OpenMetrics, exemplars included, and the
``/internal/metrics`` JSON view (``collect``) is equal. Registry parity:
after importing the port's counterparts of the modules JAX's metric-names
lint imports (``REGISTRY_MODULES``), the port's registry holds exactly JAX's
families (name, type, label names, buckets) but for one module the port
does not have: ``engine.compile_watch`` (XLA compile telemetry; nothing
compiles at serving time in the port). Exact comparisons: no tolerance
applies.

These tests build private registries for the exposition checks and only
read the process registries: JAX's is shared with the lint tests of the
same worker."""
import math
import pathlib
import re

import numpy as np
import pytest

from generativeaiexamples_tpu.utils import metrics as jm
from generativeaiexamples_tpu_torch.utils import metrics as tm
from tools.genai_lint.rules.metric_names import REGISTRY_MODULES

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: JAX registry modules the port does not port, and why
NOT_PORTED = {
    "generativeaiexamples_tpu.engine.compile_watch": "no XLA compiles to watch",
}


def _fill(mod, seed: int, monkeypatch):
    """A registry of each kind of family, with the same observations."""
    monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(seed)
    c = reg.counter("genai_test_requests_total", "Requests.\nSecond line \\ escaped.",
                    ("route", "status"))
    g = reg.gauge("genai_test_depth", "Depth.")
    h = reg.histogram("genai_test_latency_seconds", "Latency.", ("kind",),
                      buckets=mod.FAST_SECONDS_BUCKETS)
    h2 = reg.histogram("genai_test_rows", "Rows.", buckets=(1, 2, 4, 8))
    u = reg.counter("genai_test_unlabeled_total", "Unlabeled.")
    for i in range(40):
        c.labels(route=f"/r{i % 3}", status="200" if i % 4 else 'quo"te').inc(
            float(rng.integers(1, 5)))
        g.set(float(rng.normal()))
        v = float(rng.exponential(0.01))
        trace = f"{int(rng.integers(0, 2**63)):032x}" if i % 3 else None
        h.labels(kind="decode" if i % 2 else "prefill").observe(v, trace_id=trace)
        h2.observe(float(rng.integers(1, 12)), trace_id=None)
        u.inc(0.5)
    g.inc(2.0)
    g.dec(0.25)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_is_byte_equal(seed, openmetrics, monkeypatch):
    want = _fill(jm, seed, monkeypatch).render(openmetrics=openmetrics)
    got = _fill(tm, seed, monkeypatch).render(openmetrics=openmetrics)
    assert got == want
    if openmetrics:
        assert ' # {trace_id="' in got and got.endswith("# EOF\n")


@pytest.mark.parametrize("seed", [3, 4])
def test_json_view_is_equal(seed, monkeypatch):
    assert _fill(tm, seed, monkeypatch).collect() == _fill(jm, seed, monkeypatch).collect()


def test_presets_and_content_types_are_jax_s():
    for name in ("DEFAULT_BUCKETS", "FAST_SECONDS_BUCKETS", "SLOW_SECONDS_BUCKETS",
                 "CONTENT_TYPE_LATEST", "CONTENT_TYPE_OPENMETRICS"):
        assert getattr(tm, name) == getattr(jm, name), name


@pytest.mark.parametrize("bad", ["Bad", "x_sum", "x_count", "x_bucket", "1x"])
def test_invalid_names_are_refused_as_jax_refuses(bad):
    with pytest.raises(ValueError) as je:
        jm.MetricsRegistry().counter(bad, "x")
    with pytest.raises(ValueError) as te:
        tm.MetricsRegistry().counter(bad, "x")
    assert str(te.value) == str(je.value)


def test_reregistration_with_another_shape_raises_in_both():
    for mod in (jm, tm):
        reg = mod.MetricsRegistry()
        reg.counter("genai_x_total", "x", ("a",))
        assert reg.counter("genai_x_total", "x", ("a",)) is reg.get("genai_x_total")
        with pytest.raises(ValueError):
            reg.gauge("genai_x_total", "x")


def test_exemplars_follow_the_port_tracer(monkeypatch):
    """The default exemplar trace id is the port tracer's active trace."""
    from generativeaiexamples_tpu_torch.utils import tracing

    tracer = tracing.Tracer(exporter=tracing.InMemorySpanExporter())
    monkeypatch.setattr(tracing, "_TRACER", tracer)
    try:
        reg = tm.MetricsRegistry()
        h = reg.histogram("genai_t_seconds", "t")
        with tracer.span("s") as span:
            h.observe(0.002)
        (ex,) = h.exemplars()
        assert ex.trace_id == f"{span.context.trace_id:032x}"
        h.observe(0.003, trace_id=None)
        assert len(h.exemplars()) == 1  # an explicit None skips the exemplar
    finally:
        tracer.shutdown()


# --------------------------------------------------------------------- #
# Registry parity


def _port_module(name: str) -> str:
    return name.replace("generativeaiexamples_tpu.", "generativeaiexamples_tpu_torch.", 1)


def _family_names_in(module: str) -> set:
    path = ROOT / (module.replace(".", "/") + ".py")
    return set(re.findall(r'"(genai_[a-z0-9_]+)"', path.read_text()))


def _shape(fam):
    buckets = tuple(fam._buckets) if hasattr(fam, "_buckets") else None
    return (fam.typ, fam.labelnames, buckets)


def test_port_registry_holds_jax_s_families():
    import importlib

    for module in REGISTRY_MODULES:
        importlib.import_module(module)
        if module not in NOT_PORTED:
            importlib.import_module(_port_module(module))
    excluded = set().union(*(_family_names_in(m) for m in NOT_PORTED))
    assert "genai_engine_hot_path_compiles_total" in excluded
    assert "genai_router_failovers_total" not in excluded
    jax = {f.name: _shape(f) for f in jm.get_registry().families()
           if f.name.startswith("genai_") and f.name not in excluded}
    port = {f.name: _shape(f) for f in tm.get_registry().families()}
    assert set(port) == set(jax), (sorted(set(port) - set(jax)), sorted(set(jax) - set(port)))
    for name in jax:
        assert port[name] == jax[name], name
    assert len(port) == 117
    assert all(math.isinf(s[2][-1]) for s in port.values() if s[2] is not None)
