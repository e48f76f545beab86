"""The port's anomaly black box (generativeaiexamples_tpu_torch/utils/blackbox.py)
against the JAX package's (generativeaiexamples_tpu/utils/blackbox.py).

The same trigger notifications (drawn from a numpy seed: SLO evaluations,
sheds, page give-ups, breaker opens, wedges, replica deaths) at the same
clock readings fire the same captures; a bundle has JAX's keys and embeds
the port's flight records (a live timeline is stamped ``blackbox_capture``)
and dispatch-timeline window; listing, fetch by id, path-traversal refusal
and eviction answer alike; the config checks refuse the same values with
the same messages; ``GENAI_BLACKBOX=off`` keeps the box disarmed. Exact
comparisons: no tolerance applies. Both boxes are reset after each test."""
import numpy as np
import pytest

from generativeaiexamples_tpu.utils import blackbox as jbb
from generativeaiexamples_tpu.utils import flight_recorder as jfr
from generativeaiexamples_tpu_torch.utils import blackbox as tbb
from generativeaiexamples_tpu_torch.utils import flight_recorder as tfr


@pytest.fixture(autouse=True)
def _reset():
    for mod in (jbb, tbb, jfr, tfr):
        mod.reset()
    yield
    for mod in (jbb, tbb, jfr, tfr):
        mod.reset()


def _drive(mod, seed, tmp, monkeypatch):
    now = {"t": 500.0}
    monkeypatch.setattr(mod.time, "monotonic", lambda: now["t"])
    fired = []
    monkeypatch.setattr(mod, "_capture", lambda trigger, detail: fired.append((trigger, detail)))
    mod.configure(enable=True, directory=str(tmp), min_interval_s=0.0, slo_breach_streak=3,
                  shed_spike=4, page_backpressure_storm=3, replica_death_storm=2)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        now["t"] += float(rng.uniform(0, 8))
        r = int(rng.integers(0, 7))
        if r == 0:
            mod.notify_slo_evaluation(bool(rng.integers(0, 2)), samples=int(rng.integers(0, 3)))
        elif r == 1:
            mod.notify_shed("engine_queue")
        elif r == 2:
            mod.notify_page_backpressure()
        elif r == 3:
            mod.notify_breaker_open("embedder")
        elif r == 4:
            mod.notify_wedged("stall")
        elif r == 5:
            mod.notify_replica_death("r1", "refused")
    return fired


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triggers_fire_as_jax_s(seed, tmp_path, monkeypatch):
    want = _drive(jbb, seed, tmp_path / "j", monkeypatch)
    got = _drive(tbb, seed, tmp_path / "t", monkeypatch)
    assert got == want and got


def _capture(mod, fr, tmp, monkeypatch):
    mod.configure(enable=True, directory=str(tmp), max_bundles=2, min_interval_s=0.0,
                  shed_spike=1)
    rec = fr.start(request_id="live")
    rec.event("http_request", path="/generate")
    ids = []
    for i in range(3):
        monkeypatch.setattr(mod.time, "time", lambda i=i: 1_700_000_000.0 + i)
        mod.notify_shed("fault_injected")
        mod.drain()
        ids.append(mod.list_bundles()[0]["id"])
    kinds = [e[1] for e in rec.events]
    fr.finish(rec)
    return mod.list_bundles(), mod.get_bundle(ids[-1]), ids, kinds


def test_bundles_are_jax_s(tmp_path, monkeypatch):
    jl, jb, jids, jkinds = _capture(jbb, jfr, tmp_path / "j", monkeypatch)
    tl, tb, tids, tkinds = _capture(tbb, tfr, tmp_path / "t", monkeypatch)
    assert set(tb) == set(jb)
    assert set(tb["flight"]) == set(jb["flight"]) and set(tb["provenance"]) == set(jb["provenance"])
    assert tb["trigger"] == jb["trigger"] == "shed_spike"
    assert [m["trigger"] for m in tl] == [m["trigger"] for m in jl]
    assert len(tl) == len(jl) == 2  # max_bundles evicts the oldest
    assert tkinds == jkinds == ["http_request"] + ["blackbox_capture"] * 3
    assert tb["flight"]["in_flight"][0]["request_id"] == "live"
    assert set(tb["dispatch_timeline"]) == {"enabled", "spans"}
    assert "# TYPE genai_blackbox_captures_total counter" in tb["metrics"]
    assert tbb.get_bundle("../etc/passwd") is None and tbb.get_bundle("nope") is None


@pytest.mark.parametrize("field,value", [
    ("enable", "yes"), ("dir", "  "), ("max_bundles", 0), ("min_interval_s", -1.0),
    ("slo_breach_streak", -1), ("shed_spike", -2), ("page_backpressure_storm", -3),
    ("replica_death_storm", -4),
])
def test_validation_messages_are_jax_s(field, value):
    from generativeaiexamples_tpu.config.schema import BlackboxConfig as JBB
    from generativeaiexamples_tpu_torch.config import BlackboxConfig as TBB

    with pytest.raises(ValueError) as je:
        jbb.validate_config(JBB(**{field: value}))
    with pytest.raises(ValueError) as te:
        tbb.validate_config(TBB(**{field: value}))
    assert str(te.value) == str(je.value)


def test_env_kill_switch_keeps_the_box_disarmed(monkeypatch):
    monkeypatch.setattr(tbb, "_ENV_ENABLED", False)
    tbb.configure(enable=True)
    assert not tbb.enabled()


def test_log_tail_holds_the_port_package_s_records():
    """Bundles read the log tail of utils/logging.py, as JAX's read its
    logging module's ring."""
    from generativeaiexamples_tpu_torch.utils import logging as tlog

    tlog.get_logger("generativeaiexamples_tpu_torch.some.module").error("tail marker %d", 7)
    assert any("tail marker 7" in line for line in tlog.recent_lines(5))
    assert tlog.recent_lines(0) == []
    assert tbb.logging_mod is tlog
