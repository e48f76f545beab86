"""The port's fault-injection registry (generativeaiexamples_tpu_torch/utils/faults.py)
against the JAX package's (generativeaiexamples_tpu/utils/faults.py): the
same spec strings and call sequences fire the same calls with the same
modes (hypothesis over specs, derandomized), malformed specs raise the
same messages, and the sites the port wires (``retrieval.search``,
``backend.stream``, ``engine.dispatch``, ``server.admission``) fire where
JAX's do. Exact comparisons: no tolerance applies."""
import os
import threading
import time

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.utils import faults as jfaults
from generativeaiexamples_tpu_torch.utils import faults as tfaults

SITES = ("retrieval.search", "engine.dispatch", "backend.stream", "server.admission",
         "replica.kill")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # a kill rule must never signal this process
    monkeypatch.setattr(os, "kill", lambda pid, sig: None)
    for mod in (jfaults, tfaults):
        mod.reset()
    yield
    for mod in (jfaults, tfaults):
        mod.reset()


def _jax_injected():
    """JAX's injected counts by (site, mode), from its metric family."""
    fam = jfaults._M_INJECTED
    return {(site, mode): fam.labels(site=site, mode=mode).value
            for site in SITES for mode in jfaults._MODES}


def _outcome(mod, site):
    try:
        mod.fault_point(site)
    except mod.FaultInjected as exc:
        return ("raised", exc.site)
    return None


_ENTRY = st.builds(
    lambda site, mode, value, at, count: (
        f"{site}:{mode}"
        + (f"={value}" if mode in ("delay", "hang") else "")
        + f"@{at}" + (f"x{count}" if count is not None else "")
    ),
    st.sampled_from(SITES),
    st.sampled_from(("error", "delay", "hang", "kill")),
    st.sampled_from(("0", "0.0005")),
    st.integers(1, 4),
    st.one_of(st.none(), st.integers(0, 3)),
)


@settings(max_examples=60, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(entries=st.lists(_ENTRY, min_size=1, max_size=4),
       calls=st.lists(st.sampled_from(SITES), min_size=1, max_size=12),
       sep=st.sampled_from([";", ",", " ; "]))
def test_specs_fire_the_same_calls_with_the_same_modes(entries, calls, sep):
    spec = sep.join(entries)
    for mod in (jfaults, tfaults):
        mod.reset()
    tfaults.injected.clear()
    assert jfaults.install(spec) == tfaults.install(spec) == len(entries)
    before = _jax_injected()
    for site in calls:
        jout, tout = _outcome(jfaults, site), _outcome(tfaults, site)
        assert jout == tout, (spec, site)
        after = _jax_injected()
        fired_j = {k: v - before[k] for k, v in after.items() if v != before[k]}
        before = after
        fired_t = dict(tfaults.injected)
        tfaults.injected.clear()
        assert fired_t == fired_j, (spec, site)
        assert jfaults.call_count(site) == tfaults.call_count(site)
    assert jfaults.active() == tfaults.active() is True


@pytest.mark.parametrize("spec", [
    "nocolon", "site:", ":error", "site:bogus@1", "site:error@0", "site:error@1x-1",
    "site:error@a", "site:delay=x@1", "a.b:error@1;c.d", "site:error@x2",
])
def test_malformed_specs_raise_the_same_messages(spec):
    errors = []
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError) as err:
            mod.install(spec)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_disabled_fast_path_never_reaches_the_trigger(monkeypatch):
    assert not tfaults.active()
    monkeypatch.setattr(tfaults, "_trigger", lambda site: (_ for _ in ()).throw(AssertionError))
    tfaults.fault_point("retrieval.search")


def test_counters_start_with_the_first_rule_and_reset_clears():
    tfaults.fault_point("engine.dispatch")  # no rule: not counted
    tfaults.configure("engine.dispatch", "error", at=2)
    assert tfaults.call_count("engine.dispatch") == 0
    tfaults.fault_point("engine.dispatch")
    with pytest.raises(tfaults.FaultInjected, match="injected fault at 'engine.dispatch'"):
        tfaults.fault_point("engine.dispatch")
    tfaults.fault_point("engine.dispatch")
    assert tfaults.call_count("engine.dispatch") == 3
    tfaults.reset()
    assert not tfaults.active() and tfaults.call_count("engine.dispatch") == 0


def test_delay_sleeps_and_hang_is_released_by_reset():
    tfaults.configure("backend.stream", "delay", value=0.1)
    t0 = time.monotonic()
    tfaults.fault_point("backend.stream")
    assert time.monotonic() - t0 >= 0.09
    tfaults.configure("engine.dispatch", "hang", value=30.0)
    done = threading.Event()
    thread = threading.Thread(target=lambda: (tfaults.fault_point("engine.dispatch"), done.set()),
                              name="test-hang", daemon=True)
    thread.start()
    time.sleep(0.1)
    assert not done.is_set()
    tfaults.reset()
    assert done.wait(5.0)


def test_kill_mode_sends_sigkill_to_this_process(monkeypatch):
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    tfaults.install("replica.kill:kill@2")
    tfaults.fault_point("replica.kill")
    tfaults.fault_point("replica.kill")
    import signal

    assert sent == [(os.getpid(), signal.SIGKILL)]


def test_install_from_env_reads_genai_faults(monkeypatch):
    monkeypatch.setenv("GENAI_FAULTS", "retrieval.search:error@1x0;backend.stream:delay=0@2")
    assert tfaults.install_from_env() == jfaults.install_from_env() == 2
    monkeypatch.delenv("GENAI_FAULTS")
    assert tfaults.install_from_env() == 0


def test_the_port_wires_the_jax_sites(monkeypatch):
    """``retrieval.search`` (chain runtime), ``backend.stream`` (both model
    backends) and ``server.admission`` fire in the port as in JAX; the
    engine's ``engine.dispatch`` and ``replica.kill`` are exercised by
    tests/test_torch_drain_restore.py."""
    from generativeaiexamples_tpu_torch.chains import runtime
    from generativeaiexamples_tpu_torch.engine.llm_backend import RemoteLLMBackend

    tfaults.install("retrieval.search:error@1;backend.stream:error@1")
    with pytest.raises(tfaults.FaultInjected, match="retrieval.search"):
        runtime.retrieve("q")
    with pytest.raises(tfaults.FaultInjected, match="backend.stream"):
        RemoteLLMBackend("http://127.0.0.1:9", "m").stream_chat([("user", "hi")])
    assert tfaults.call_count("retrieval.search") == tfaults.call_count("backend.stream") == 1
