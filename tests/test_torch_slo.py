"""The port's SLO tracker (generativeaiexamples_tpu_torch/utils/slo.py) against
the JAX package's (generativeaiexamples_tpu/utils/slo.py): the same latency
samples and rate events (drawn from a numpy seed) at the same clock
readings give equal evaluations (p95s, attainments, rates, burn state
``met``/``all_met``) and gauge values, before and after the window slides;
the config checks refuse the same values with the same messages; and
``slo.enable=off`` disables every objective in both. Exact comparisons: no
tolerance applies. Both black boxes are disarmed around every case, and
their capture workers joined: a box that another test file in the same
process left armed fires ``slo_breach`` captures on this file's breach
streaks, and a capture evaluates the SLOs and writes the ``genai_slo_*``
gauges that the cases read."""
import numpy as np
import pytest

from generativeaiexamples_tpu.utils import blackbox as jbb
from generativeaiexamples_tpu.utils import slo as jslo
from generativeaiexamples_tpu_torch.utils import blackbox as tbb
from generativeaiexamples_tpu_torch.utils import slo as tslo


@pytest.fixture(autouse=True)
def _disarmed_black_boxes():
    for mod in (jbb, tbb):
        mod.drain()
        mod.reset()
    yield
    for mod in (jbb, tbb):
        mod.drain()
        mod.reset()


def _drive(mod, seed, monkeypatch):
    now = {"t": 1000.0}
    monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
    tracker = mod.SLOTracker(window_s=30.0, ttft_p95_ms=400.0, inter_token_p95_ms=50.0,
                             shed_rate_max=0.1, degraded_rate_max=0.2)
    rng = np.random.default_rng(seed)
    out = []
    for step in range(300):
        now["t"] += float(rng.uniform(0, 0.4))
        r = int(rng.integers(0, 6))
        if r == 0:
            tracker.observe_latency("ttft_p95", float(rng.exponential(0.3)))
        elif r == 1:
            tracker.observe_latency("inter_token_p95", float(rng.exponential(0.03)))
        else:
            tracker.observe_event(("shed", "admitted", "degraded", "answered")[r - 2])
        if step % 50 == 49:
            ev = tracker.evaluate()
            gauges = {o: (mod._M_ATTAIN.labels(objective=o).value,
                          mod._M_MET.labels(objective=o).value) for o in ev["objectives"]}
            out.append((ev, gauges))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluations_are_jax_s(seed, monkeypatch):
    assert _drive(tslo, seed, monkeypatch) == _drive(jslo, seed, monkeypatch)


@pytest.mark.parametrize("field,value", [
    ("enable", "sometimes"), ("window_s", 0.0), ("ttft_p95_ms", -1.0),
    ("inter_token_p95_ms", -2.0), ("shed_rate_max", 1.5), ("degraded_rate_max", -0.1),
    ("router_proxy_overhead_p95_ms", -3.0), ("router_failover_rate_max", 2.0),
])
def test_validation_messages_are_jax_s(field, value):
    from generativeaiexamples_tpu.config.schema import SLOConfig as JSLO
    from generativeaiexamples_tpu_torch.config import SLOConfig as TSLO

    with pytest.raises(ValueError) as je:
        jslo.validate_config(JSLO(**{field: value}))
    with pytest.raises(ValueError) as te:
        tslo.validate_config(TSLO(**{field: value}))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("enable", ["on", "off"])
def test_configure_from_config_is_jax_s(enable, monkeypatch):
    from generativeaiexamples_tpu.config.schema import SLOConfig as JSLO
    from generativeaiexamples_tpu_torch.config import SLOConfig as TSLO

    out = {}
    for mod, cfg in ((jslo, JSLO(enable=enable)), (tslo, TSLO(enable=enable))):
        saved = mod._TRACKER
        try:
            mod.configure_from_config(cfg)
            monkeypatch.setattr(mod.time, "monotonic", lambda: 50.0)
            mod.observe_latency("ttft_p95", 40.0)
            mod.observe_event("shed")
            out[mod] = mod.summary()
        finally:
            mod._TRACKER = saved
    assert out[tslo] == out[jslo]
    assert bool(out[tslo]["objectives"]) == (enable == "on")
