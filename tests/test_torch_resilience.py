"""The port's retries and circuit breakers (generativeaiexamples_tpu_torch/utils/resilience.py)
against the JAX package's (generativeaiexamples_tpu/utils/resilience.py):

- ``backoff_schedule`` gives equal delays for the same policy and seed
  (exact: the same ``random.Random`` draws);
- breaker transitions are equal step by step under one fake clock;
- ``call_with_resilience`` makes the same attempts and sleeps, and ends in
  the same outcome, for the same scripts of failures (hypothesis,
  derandomized);
- the urllib transient filter sorts a failed connect, a timeout and every
  status 400-599 as JAX's sorts the ``requests`` errors;
- ``validate_config`` raises JAX's messages;
- the port's remote clients retry over HTTP (a stub server that answers
  503 twice, then serves) and open their breaker after
  ``breaker_failure_threshold`` failures; BM25 search runs behind a
  one-attempt breaker, as in JAX.
"""
import dataclasses
import json
import socket
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import requests
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.config import ResilienceConfig as JResilienceConfig
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.utils import resilience as jres
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.utils import resilience as tres


@pytest.fixture(autouse=True)
def _clean(clean_app_env):
    for mod in (jres, tres):
        mod.reset_breakers()
        mod.set_current_deadline(None)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()
    yield clean_app_env
    for mod in (jres, tres):
        mod.reset_breakers()
        mod.set_current_deadline(None)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


_POLICY = st.builds(
    lambda n, base, cap, mult, jit: (n, base, cap, mult, jit),
    st.integers(1, 8), st.sampled_from([0.0, 0.01, 0.05, 0.3]),
    st.sampled_from([0.0, 0.1, 2.0]), st.sampled_from([1.0, 2.0, 3.0]),
    st.sampled_from([0.0, 0.25, 0.5, 1.0]),
)


@settings(max_examples=80, derandomize=True, deadline=None)
@given(policy=_POLICY, seed=st.one_of(st.none(), st.integers(0, 2**31)))
def test_backoff_schedule_is_jax_s(policy, seed):
    n, base, cap, mult, jit = policy
    a = jres.backoff_schedule(jres.RetryPolicy(n, base, cap, mult, jit), seed=seed)
    b = tres.backoff_schedule(tres.RetryPolicy(n, base, cap, mult, jit), seed=seed)
    if seed is None and jit:
        assert len(a) == len(b) == n - 1
    else:
        assert a == b


@settings(max_examples=60, derandomize=True, deadline=None)
@given(ops=st.lists(st.sampled_from(["acquire", "success", "failure", "release", "tick",
                                     "state"]), max_size=40),
       threshold=st.integers(1, 4), recovery=st.sampled_from([0.5, 1.0, 3.0]))
def test_breaker_transitions_are_jax_s_under_a_fake_clock(ops, threshold, recovery):
    jclock, tclock = FakeClock(), FakeClock()
    jb = jres.CircuitBreaker("dep", threshold, recovery, clock=jclock)
    tb = tres.CircuitBreaker("dep", threshold, recovery, clock=tclock)
    for op in ops:
        if op == "tick":
            jclock.t += 0.6
            tclock.t += 0.6
            continue
        fn = {"acquire": "acquire", "success": "record_success", "failure": "record_failure",
              "release": "release_probe"}.get(op)
        if fn is None:
            assert jb.state == tb.state
            continue
        assert getattr(jb, fn)() == getattr(tb, fn)()
        assert (jb._state, jb._failures, jb._probe_in_flight) == \
            (tb._state, tb._failures, tb._probe_in_flight)


class Boom(ConnectionError):
    pass


def _trace(mod, script, attempts, filt, seed):
    """Attempts, sleeps and outcome of one guarded call whose i-th attempt
    raises ``script[i]`` ("fail", "client" or "ok"); a fresh breaker of
    threshold 3 each call."""
    calls, sleeps = [], []

    class ClientError(Exception):
        pass

    def fn():
        i = len(calls)
        calls.append(i)
        kind = script[i] if i < len(script) else "ok"
        if kind == "fail":
            raise Boom(f"down {i}")
        if kind == "client":
            raise ClientError("bad request")
        return f"ok {i}"

    breaker = mod.CircuitBreaker("dep", 3, 30.0, clock=FakeClock())
    try:
        out = ("result", mod.call_with_resilience(
            "dep", fn, policy=mod.RetryPolicy(max_attempts=4, base_delay=0.05, jitter=0.5),
            attempts=attempts, breaker=breaker, sleep=sleeps.append, seed=seed,
            retry_filter=(lambda exc: not isinstance(exc, ClientError)) if filt else None))
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        out = (type(exc).__name__, str(exc))
    return calls, sleeps, out, breaker._state


@settings(max_examples=80, derandomize=True, deadline=None)
@given(script=st.lists(st.sampled_from(["fail", "client", "ok"]), max_size=6),
       attempts=st.one_of(st.none(), st.integers(1, 5)), filt=st.booleans(),
       seed=st.integers(0, 1000))
def test_call_with_resilience_traces_are_jax_s(script, attempts, filt, seed):
    assert _trace(jres, script, attempts, filt, seed) == _trace(tres, script, attempts, filt, seed)


def test_open_breaker_fails_fast_and_deadline_and_overload_pass_through():
    for mod in (jres, tres):
        br = mod.CircuitBreaker("x", 1, 30.0, clock=FakeClock())
        br.record_failure()
        with pytest.raises(mod.CircuitOpenError, match="circuit breaker open for 'x'"):
            mod.call_with_resilience("x", lambda: 1, breaker=br)
        for exc in (mod.DeadlineExceeded("late"), mod.EngineOverloaded("full")):
            calls = []

            def raise_it(exc=exc):
                calls.append(1)
                raise exc

            with pytest.raises(type(exc)):
                mod.call_with_resilience("y", raise_it, sleep=lambda _: None)
            assert calls == [1]
        assert mod.get_breaker("y").state == "closed"


def test_disable_calls_once_with_the_original_error(clean_app_env):
    clean_app_env.setenv("APP_RESILIENCE_ENABLE", "off")
    for mod in (jres, tres):
        calls = []

        def dead():
            calls.append(1)
            raise ConnectionError("down")

        with pytest.raises(ConnectionError):
            mod.call_with_resilience("offdep", dead, sleep=lambda _: None)
        assert calls == [1]


def _requests_error(status):
    if status is None:
        return requests.ConnectionError("refused")
    resp = requests.Response()
    resp.status_code = status
    return requests.HTTPError(f"{status}", response=resp)


def _urllib_error(status):
    if status is None:
        return urllib.error.URLError(ConnectionRefusedError(111, "refused"))
    return urllib.error.HTTPError("http://x/v1", status, "status", {}, None)


@pytest.mark.parametrize("status", [None] + list(range(400, 600)))
def test_urllib_transient_filter_sorts_as_jax_s_requests_filter(status):
    assert tres.http_error_is_transient(_urllib_error(status)) == \
        jres.http_error_is_transient(_requests_error(status))
    assert isinstance(_urllib_error(status), tres.URL_ERRORS)


def test_timeouts_and_resets_are_transient():
    for exc in (socket.timeout("timed out"), ConnectionResetError(104, "reset"),
                TimeoutError("read")):
        assert tres.http_error_is_transient(exc) and isinstance(exc, tres.URL_ERRORS)


@pytest.mark.parametrize("field,value", [
    ("enable", "maybe"), ("request_deadline_ms", -1), ("max_active_streams", -2),
    ("engine_queue_cap", -1), ("shed_retry_after_s", 0.0), ("retry_max_attempts", 0),
    ("retry_base_delay_ms", -1), ("retry_max_delay_ms", -5), ("retry_jitter", 1.5),
    ("breaker_failure_threshold", 0), ("breaker_recovery_s", 0.0),
    ("faults", "nocolon"), ("faults", ":error@1"),
])
def test_validate_config_raises_jax_s_messages(field, value):
    messages = []
    for mod, cls in ((jres, JResilienceConfig), (tres, tconfig.ResilienceConfig)):
        with pytest.raises(ValueError) as err:
            mod.validate_config(dataclasses.replace(cls(), **{field: value}))
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    tres.validate_config(tconfig.ResilienceConfig())


def test_policy_and_breaker_thresholds_come_from_the_config(clean_app_env):
    for name, value in [("RETRYMAXATTEMPTS", "7"), ("RETRYBASEDELAYMS", "10"),
                        ("RETRYMAXDELAYMS", "40"), ("RETRYJITTER", "0.0"),
                        ("BREAKERFAILURETHRESHOLD", "2"), ("BREAKERRECOVERYS", "4.5")]:
        clean_app_env.setenv(f"APP_RESILIENCE_{name}", value)
    assert tres.policy_from_config() == tres.RetryPolicy(7, 0.01, 0.04, 2.0, 0.0)
    assert dataclasses.asdict(tres.policy_from_config()) == \
        dataclasses.asdict(jres.policy_from_config())
    br = tres.get_breaker("cfg")
    assert (br.failure_threshold, br.recovery_s) == (2, 4.5)


# --------------------------------------------------------------------------- #
# the remote clients over HTTP


class _Flaky(BaseHTTPRequestHandler):
    """Answers ``fail`` 503s (or 400s), then serves every client's route."""

    fail = 0
    status = 503
    hits = 0

    def log_message(self, *args):
        pass

    def do_POST(self):  # noqa: N802
        cls = type(self)
        cls.hits += 1
        self.rfile.read(int(self.headers.get("Content-Length", "0")))
        if cls.hits <= cls.fail:
            self.send_response(cls.status)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if self.path.endswith("/embeddings"):
            body = {"data": [{"index": 0, "embedding": [1.0, 0.0]}]}
        elif self.path.endswith("/ranking"):
            body = {"rankings": [{"index": 0, "logit": 2.0}]}
        else:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            frame = {"choices": [{"delta": {"content": "hi"}}]}
            self.wfile.write(f"data: {json.dumps(frame)}\n\ndata: [DONE]\n\n".encode())
            return
        data = json.dumps(body).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture
def flaky():
    handler = type("Flaky", (_Flaky,), {"fail": 0, "status": 503, "hits": 0})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, name="test-flaky", daemon=True)
    thread.start()
    yield handler, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(10)


def _clients(url):
    from generativeaiexamples_tpu_torch.engine.embedder import RemoteEmbedder
    from generativeaiexamples_tpu_torch.engine.llm_backend import RemoteLLMBackend
    from generativeaiexamples_tpu_torch.engine.reranker import RemoteReranker

    return {
        "embedder": lambda: RemoteEmbedder(url, "m", dimensions=2).embed_documents(["x"]),
        "reranker": lambda: RemoteReranker(url, "m").score("q", ["p"]),
        "llm_remote": lambda: "".join(RemoteLLMBackend(url, "m").stream_chat([("user", "x")])),
    }


@pytest.mark.parametrize("dep", ["embedder", "reranker", "llm_remote"])
def test_remote_clients_retry_503s_to_success(flaky, clean_app_env, dep):
    """Two 503s, then an answer: JAX's three attempts (``retry_max_attempts``
    3), two retries counted, the breaker closed."""
    handler, url = flaky
    handler.fail = 2
    clean_app_env.setenv("APP_RESILIENCE_RETRYBASEDELAYMS", "1")
    before = tres.retries[dep]
    _clients(url)[dep]()
    assert handler.hits == 3 and tres.retries[dep] - before == 2
    assert tres.get_breaker(dep).state == "closed"


@pytest.mark.parametrize("dep", ["embedder", "reranker", "llm_remote"])
def test_remote_clients_open_the_breaker_and_do_not_retry_client_errors(flaky, clean_app_env,
                                                                        dep):
    handler, url = flaky
    clean_app_env.setenv("APP_RESILIENCE_RETRYBASEDELAYMS", "1")
    handler.fail, handler.status = 10**6, 400
    with pytest.raises(urllib.error.HTTPError):
        _clients(url)[dep]()
    assert handler.hits == 1 and tres.get_breaker(dep).state == "closed"
    handler.status, handler.hits = 503, 0
    clean_app_env.setenv("APP_RESILIENCE_BREAKERFAILURETHRESHOLD", "2")
    tconfig.get_config.cache_clear()
    tres.reset_breakers()
    with pytest.raises(tres.DependencyUnavailable, match="failed after"):
        _clients(url)[dep]()
    assert tres.get_breaker(dep).state == "open"
    hits = handler.hits
    with pytest.raises(tres.CircuitOpenError):
        _clients(url)[dep]()
    assert handler.hits == hits  # failed fast, no request sent


def test_bm25_search_runs_behind_a_one_attempt_breaker_as_in_jax(monkeypatch):
    """A failing index: each search is one attempt (typed
    ``DependencyUnavailable``), the ``bm25`` breaker opens at the
    threshold and later searches fail fast, in both packages."""
    from generativeaiexamples_tpu.retrieval import bm25 as jbm25
    from generativeaiexamples_tpu.retrieval.store import Chunk as JChunk
    from generativeaiexamples_tpu_torch.retrieval import bm25 as tbm25
    from generativeaiexamples_tpu_torch.retrieval.store import Chunk as TChunk

    outcomes = []
    for mod, res, chunk in ((jbm25, jres, JChunk), (tbm25, tres, TChunk)):
        index = mod.BM25Index()
        index.add([chunk(text="alpha beta", source="a"), chunk(text="beta gamma", source="b")])
        assert [h.chunk.source for h in index.search("alpha", 2)][0] == "a"
        calls = []

        def broken(*args, calls=calls):
            calls.append(1)
            raise RuntimeError("corrupt index")

        monkeypatch.setattr(mod, "tokenize", broken)
        seen = []
        for _ in range(7):
            try:
                index.search("alpha", 2)
                seen.append("ok")
            except res.CircuitOpenError:
                seen.append("open")
            except res.DependencyUnavailable:
                seen.append("unavailable")
        outcomes.append(seen)
    assert outcomes[0] == outcomes[1] == ["unavailable"] * 5 + ["open"] * 2
