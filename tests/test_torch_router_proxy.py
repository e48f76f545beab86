"""The port's router (generativeaiexamples_tpu_torch/router/app.py) and the
JAX package's aiohttp router side by side, in front of the same
standard-library stub replicas, on the CPU.

The stubs play the chain server: event-stream ``/generate`` frames in
chunked framing (as aiohttp writes them), JSON errors with scripted
statuses and headers, a 500 event stream, a stream ending in a
``PREEMPTED`` terminator whose warning names a snapshot, the snapshot
spool, ``/internal/restore`` with its ``X-GenAI-Restore`` ack (or a
refusal), a stream cut before its last chunk, ``/documents``,
``/internal/requests?trace=`` and ``/internal/ready``. For the cases of
``tests/test_router.py`` and ``tests/test_router_handover.py`` (and a 500
stream, which passes through), each router answers the same request in
turn and the two must give the same status, ``X-GenAI-Replica``,
forwarded headers and client bytes, make the same upstream calls, and
move the ``genai_router_*`` samples alike (counter and histogram-count
deltas, gauge values) in their packages' registries. Port-only: a client
that goes away closes the upstream connection, and a close-delimited
stream that ends before ``[DONE]`` (the port's servers' framing) is a
death. Exact comparisons: no tolerance applies."""
import asyncio
import http.client
import json
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from aiohttp import web

from generativeaiexamples_tpu.router.app import RouterServer as JRouterServer
from generativeaiexamples_tpu.router.ring import HashRing
from generativeaiexamples_tpu.utils import flight_recorder as jfr
from generativeaiexamples_tpu.utils import metrics as jmetrics
from generativeaiexamples_tpu_torch.router import app as tapp
from generativeaiexamples_tpu_torch.router import metrics as trm  # noqa: F401 - registers
from generativeaiexamples_tpu_torch.utils import flight_recorder as tfr
from generativeaiexamples_tpu_torch.utils import metrics as tmetrics

SID = "snap-7-feedface"
PREFIX = ["Hello ", "wor"]          # forwarded before the preemption
TRANSCRIPT = ["Hello ", "world!"]   # the full re-delivered stream
COMPARED_HEADERS = ("Content-Type", "Retry-After", "X-GenAI-Queue-Depth",
                    "X-GenAI-Replica", "Access-Control-Allow-Origin")


def _frame(content="", finish="", warnings=None, rid="resp-x"):
    doc = {"id": rid, "choices": [{
        "index": 0, "message": {"role": "assistant", "content": content},
        "finish_reason": finish}]}
    if warnings:
        doc["warnings"] = warnings
    return f"data: {json.dumps(doc)}\n\n"


def _client_text(body: bytes) -> str:
    out = []
    for part in body.decode().split("\n\n"):
        if part.startswith("data: "):
            doc = json.loads(part[len("data: "):])
            for choice in doc.get("choices", []):
                content = (choice.get("message") or {}).get("content")
                if isinstance(content, str):
                    out.append(content)
    return "".join(out)


# --------------------------------------------------------------------------- #
# Stub replicas


class Stub:
    """A scripted replica. ``mode`` picks /generate's answer: ``frames``
    (200 event stream of ``frames``), ``status`` (JSON ``{"detail":
    "scripted"}`` at ``status`` with ``headers``), ``error_stream`` (a
    500 event stream), ``preempt`` (PREFIX then a PREEMPTED terminator
    naming SID), ``die`` (PREFIX, then the connection closes before the
    last chunk), ``transcript`` (TRANSCRIPT then ``[DONE]``) or
    ``close_delimited`` (PREFIX with no framing, then a close)."""

    def __init__(self, mode="frames", status=200, headers=None,
                 frames=('data: {"answer": "ok"}\n\n',), restore_status=200):
        self.mode, self.status, self.headers = mode, status, dict(headers or {})
        self.frames, self.restore_status = frames, restore_status
        self.trace_timelines = {}
        self.doc = {"snapshot_id": SID, "version": 1, "prompt_ids": [1, 2, 3],
                    "emitted": [9, 9]}
        self.reset()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def _json(self, doc, status=200, headers=None):
                data = json.dumps(doc).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def _stream(self, frames, status=200, headers=None, cut=False):
                self.send_response(status)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                for f in frames:
                    data = f.encode()
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                    self.wfile.flush()
                if cut:  # a reclaimed machine sends no last chunk
                    self.close_connection = True
                    self.connection.shutdown(socket.SHUT_RDWR)
                    return
                self.wfile.write(b"0\r\n\r\n")

            def do_GET(self):  # noqa: N802
                url = urllib.parse.urlsplit(self.path)
                stub.calls.append(("GET", url.path))
                if url.path == "/internal/ready":
                    return self._json({"ready": True, "wedged": False})
                if url.path == "/documents":
                    return self._json({"documents": ["a.txt"]})
                if url.path == "/v1/models":
                    return self._json({"object": "list", "data": [{"id": "m"}]})
                if url.path == "/internal/requests":
                    trace = urllib.parse.parse_qs(url.query).get("trace", [""])[0]
                    return self._json({"timelines": stub.trace_timelines.get(trace, [])})
                if url.path == f"/internal/snapshots/{SID}":
                    return self._json(stub.doc)
                return self._json({"detail": "nope"}, 404)

            def do_DELETE(self):  # noqa: N802
                stub.calls.append(("DELETE", self.path))
                self._body()
                return self._json({"message": "deleted"})

            def do_POST(self):  # noqa: N802
                url = urllib.parse.urlsplit(self.path)
                body = self._body()
                stub.calls.append(("POST", url.path))
                stub.bodies.append(body)
                stub.req_headers.append(dict(self.headers))
                if url.path == "/documents":
                    return self._json({"message": "ingested"})
                if url.path == "/internal/restore":
                    if stub.restore_status != 200:
                        return self._json({"detail": "scripted refusal"}, stub.restore_status)
                    return self._stream([_frame(c) for c in TRANSCRIPT] + [_frame(finish="[DONE]")],
                                        headers={"X-GenAI-Restore": f"{SID}; mode=restore"})
                mode = stub.mode
                if mode == "status":
                    return self._json({"detail": "scripted"}, stub.status, stub.headers)
                if mode == "frames":
                    return self._stream(stub.frames, headers=stub.headers)
                if mode == "error_stream":
                    return self._stream([_frame("Error from chain server.", finish="[DONE]")], 500)
                if mode == "transcript":
                    return self._stream([_frame(c) for c in TRANSCRIPT] + [_frame(finish="[DONE]")])
                if mode == "preempt":
                    return self._stream([_frame(c) for c in PREFIX] + [_frame(
                        finish="PREEMPTED", warnings=[f"preempted snapshot_id={SID}"])])
                if mode == "die":
                    return self._stream([_frame(c) for c in PREFIX], cut=True)
                if mode == "close_delimited":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    for c in PREFIX:
                        self.wfile.write(_frame(c).encode())
                    self.close_connection = True
                    return None
                raise AssertionError(mode)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, name="stub-replica",
                         daemon=True).start()

    def reset(self):
        self.calls, self.bodies, self.req_headers = [], [], []

    def generate_calls(self):
        return sum(1 for c in self.calls if c == ("POST", "/generate"))

    def close(self):
        self.server.shutdown()
        self.server.server_close()


# --------------------------------------------------------------------------- #
# The two routers


class JaxRouter:
    """The JAX package's router app on a TCP port, its event loop in a
    thread of its own."""

    def __init__(self, urls):
        from generativeaiexamples_tpu.config import AppConfig

        self.router = JRouterServer(AppConfig.from_dict({}), replica_urls=urls)
        app = self.router.build_app()
        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.runner = web.AppRunner(app)
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.port = site._server.sockets[0].getsockname()[1]
            ready.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, name="jax-router", daemon=True)
        self.thread.start()
        assert ready.wait(30)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


class PortRouter:
    def __init__(self, urls):
        from generativeaiexamples_tpu_torch.config import AppConfig

        self.router = tapp.RouterServer(AppConfig.from_env(), replica_urls=urls)
        self.server = self.router.build_server("127.0.0.1", 0)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, name="port-router",
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.router.stop()
        self.server.shutdown()
        self.server.server_close()


def call(port, method, path, body=None, headers=None, timeout=30):
    """(status, headers, body bytes) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
        hdrs = dict(headers or {})
        if isinstance(body, (dict, list)):
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        try:
            payload = resp.read()
        except http.client.IncompleteRead as exc:  # a truncated stream
            payload = exc.partial
        return resp.status, {k: resp.getheader(k) for k in COMPARED_HEADERS}, payload
    finally:
        conn.close()


def _gen(message):
    return ("POST", "/generate", {"messages": [{"role": "user", "content": message}]})


def _router_samples(registry):
    """``{(family, labels): value}`` of the genai_router_* families:
    counter and gauge values, histogram counts; and the gauge families."""
    out, gauges = {}, set()
    for name, fam in registry.collect().items():
        if not name.startswith("genai_router_"):
            continue
        if fam["type"] == "gauge":
            gauges.add(name)
        for s in fam["series"]:
            key = (name, tuple(sorted(s["labels"].items())))
            out[key] = s["count"] if "count" in s else s["value"]
    return out, gauges


def run_both(stubs, script, monkeypatch, **env):
    """Run ``script(port, router)`` through the JAX router, then the
    port's, in front of the same stubs (reset between); returns each
    side's (script result, per-stub calls, router samples before and
    after, gauge families)."""
    env.setdefault("APP_ROUTER_HEALTHINTERVALS", "60")  # no poll mid-test
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    urls = [s.url for s in stubs]
    out = []
    for cls, registry in ((JaxRouter, jmetrics.get_registry()),
                          (PortRouter, tmetrics.get_registry())):
        for s in stubs:
            s.reset()
        before, _ = _router_samples(registry)
        router = cls(urls)
        try:
            result = script(router.port, router.router)
        finally:
            router.close()
        calls = [list(s.calls) for s in stubs]
        after, gauges = _router_samples(registry)
        out.append((result, calls, before, after, gauges))
    return out


@pytest.fixture
def stubs():
    made = []

    def make(*args, **kwargs):
        s = Stub(*args, **kwargs)
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()


@pytest.fixture(autouse=True)
def _env(clean_app_env):
    for mod in (jfr, tfr):
        mod.reset()
    yield clean_app_env
    for mod in (jfr, tfr):
        mod.reset()


def _ordered(message, owner, sibling):
    """[owner, sibling] in the slots that make ``owner`` the ring's pick."""
    return [owner, sibling] if HashRing(["r0", "r1"]).owner(message) == "r0" else [sibling, owner]


def _same(results):
    """Both routers gave the same result, made the same upstream calls,
    moved each counter and histogram count by the same amount, and left
    the same value in every gauge series either of them set (the process
    registries keep other tests' series: those neither run touched are
    not compared)."""
    (jres, jcalls, jb, ja, gauges), (tres, tcalls, tb, ta, _) = results
    assert tres == jres
    assert tcalls == jcalls

    def moved(before, after):
        return {k: v - before.get(k, 0.0) for k, v in after.items()
                if k[0] not in gauges and v != before.get(k, 0.0)}

    assert moved(tb, ta) == moved(jb, ja)
    touched = {k for b, a in ((jb, ja), (tb, ta)) for k in a
               if k[0] in gauges and b.get(k) != a[k]}
    assert {k: ta.get(k) for k in touched} == {k: ja.get(k) for k in touched}
    return jres


# --------------------------------------------------------------------------- #
# tests/test_router.py's proxy cases


def test_routes_and_stamps_replica_header(stubs, _env):
    a, b = stubs(), stubs()
    res = _same(run_both([a, b], lambda port, r: call(port, *_gen("hello")), _env))
    assert res[0] == 200 and res[1]["X-GenAI-Replica"] == HashRing(["r0", "r1"]).owner("hello")
    assert b"ok" in res[2]


def test_affinity_keeps_a_conversation_on_one_replica(stubs, _env):
    a, b = stubs(), stubs()

    def script(port, router):
        seen, history = [], [{"role": "user", "content": "the original question"}]
        for turn in range(4):
            status, headers, _ = call(port, "POST", "/generate", {"messages": list(history)})
            seen.append((status, headers["X-GenAI-Replica"]))
            history += [{"role": "assistant", "content": f"answer {turn}"},
                        {"role": "user", "content": f"follow-up {turn}"}]
        return seen

    seen = _same(run_both([a, b], script, _env))
    assert len({r for _, r in seen}) == 1


def test_failover_retries_on_sibling_before_first_byte(stubs, _env):
    broken, good = stubs("status", status=503), stubs()
    res = _same(run_both(_ordered("failover probe", broken, good),
                         lambda port, r: call(port, *_gen("failover probe")), _env))
    assert res[0] == 200
    assert broken.generate_calls() == 1 and good.generate_calls() == 1


@pytest.mark.parametrize("n_replicas,env", [(2, {"APP_ROUTER_FAILOVERRETRY": "off"}), (1, {})],
                         ids=["failover_off", "no_sibling"])
def test_upstream_429_passes_through_with_headers(stubs, _env, n_replicas, env):
    reps = [stubs("status", status=429, headers={"Retry-After": "3", "X-GenAI-Queue-Depth": "9"})
            for _ in range(n_replicas)]

    def script(port, router):
        status, headers, body = call(port, *_gen("overload"))
        return status, headers, body, router.monitor.queue_depth(headers["X-GenAI-Replica"])

    res = _same(run_both(reps, script, _env, **env))
    assert res[0] == 429 and res[1]["Retry-After"] == "3" and res[3] == 9


def test_tenant_shed_answers_429_before_any_replica(stubs, _env):
    a, b = stubs(), stubs()

    def script(port, router):
        router.governor.admit("capped")  # hold the tenant's single slot
        return call(port, *_gen("hi"), headers={"X-GenAI-Tenant": "capped"})

    res = _same(run_both([a, b], script, _env, APP_ROUTER_TENANTS="capped:inflight=1"))
    assert res[0] == 429 and res[1]["Retry-After"] == "1"
    assert a.calls == [] and b.calls == []


def test_tenant_rate_sheds_the_second_request_within_a_second(stubs, _env):
    a, b = stubs(), stubs()

    def script(port, router):
        hdrs = {"X-GenAI-Tenant": "limited"}
        return [call(port, *_gen("q"), headers=hdrs)[:2] for _ in range(2)]

    res = _same(run_both([a, b], script, _env, APP_ROUTER_TENANTS="limited:rate=1,burst=1"))
    assert [s for s, _ in res] == [200, 429] and res[1][1]["Retry-After"] == "1"


def test_policy_switch_fleet_view_and_drain_workflow(stubs, _env):
    a, b = stubs(), stubs()

    def script(port, router):
        out = [call(port, "GET", "/internal/fleet"),
               call(port, "POST", "/internal/policy", {"policy": "round_robin"}),
               call(port, "POST", "/internal/policy", {"policy": "bogus"}),
               call(port, "POST", "/internal/policy", b"not json"),
               call(port, "POST", "/internal/drain/r0"),
               call(port, "POST", "/internal/drain/nope"),
               call(port, "GET", "/internal/fleet")]
        out += [call(port, *_gen(f"q{i}")) for i in range(4)]
        out += [call(port, "POST", "/internal/undrain/r0"), call(port, "GET", "/internal/ready")]
        out += [call(port, *_gen(f"rr{i}"))[1]["X-GenAI-Replica"] for i in range(4)]
        return out

    out = _same(run_both([a, b], script, _env))
    assert json.loads(out[6][2])["placeable"] == ["r1"]
    assert [o[1]["X-GenAI-Replica"] for o in out[7:11]] == ["r1"] * 4
    assert out[-4:] == ["r0", "r1", "r0", "r1"]


def test_ingest_broadcasts_to_every_replica(stubs, _env):
    a, b = stubs(), stubs()

    def script(port, router):
        return [call(port, "POST", "/documents", {"documents": ["x"]}),
                call(port, "DELETE", "/documents?filename=x.txt"),
                call(port, "GET", "/documents"), call(port, "GET", "/v1/models")]

    out = _same(run_both([a, b], script, _env))
    assert json.loads(out[0][2])["replicas"] == {"r0": 200, "r1": 200}
    assert ("DELETE", "/documents?filename=x.txt") in a.calls


def test_no_placeable_replica_is_503(stubs, _env):
    a = stubs()

    def script(port, router):
        router.monitor.drain("r0")
        return [call(port, *_gen("x")), call(port, "GET", "/internal/ready")]

    out = _same(run_both([a], script, _env))
    assert [o[0] for o in out] == [503, 503] and a.calls == []


def test_stitched_trace_merges_router_hops_with_replica_phases(stubs, _env):
    trace = "ab" * 16
    a = stubs()
    a.trace_timelines[trace] = [{
        "request_id": "rep-1", "trace_id": trace, "started_at": time.time(),
        "outcome": "finish", "done": True, "ttft_s": 0.1, "total_s": 0.2,
        "timeline": [{"t_s": 0.0, "event": "submit", "rid": 1},
                     {"t_s": 0.01, "event": "admit", "queue_wait_s": 0.01},
                     {"t_s": 0.1, "event": "first_token"}]}]
    _env.setenv("ENABLE_TRACING", "1")
    _env.setenv("TRACE_EXPORTER", "memory")
    from generativeaiexamples_tpu.utils.tracing import reset_tracer as jreset
    from generativeaiexamples_tpu_torch.utils.tracing import reset_tracer as treset

    jreset()
    treset()

    def script(port, router):
        status = call(port, *_gen("stitch me"),
                      headers={"traceparent": f"00-{trace}-00f067aa0ba902b7-01"})[0]
        doc = json.loads(call(port, "GET", f"/internal/trace/{trace}")[2])
        events = {}
        for entry in doc["timeline"]:
            events.setdefault(entry["source"], []).append(entry["event"])
        ts = [entry["t_s"] for entry in doc["timeline"]]
        return (status, doc["trace_id"], sorted(s["source"] for s in doc["sources"]), events,
                ts == sorted(ts), call(port, "GET", "/internal/trace/banana")[0],
                call(port, "GET", f"/internal/trace/{'cd' * 16}")[0])

    try:
        res = _same(run_both([a], script, _env))
    finally:
        _env.delenv("ENABLE_TRACING")
        jreset()
        treset()
    assert res[2] == ["r0", "router"] and res[4] and res[5:] == (400, 404)
    for kind in ("placement", "proxied", "first_byte", "finish"):
        assert kind in res[3]["router"]
    assert res[3]["r0"] == ["submit", "admit", "first_token"]


def test_a_500_event_stream_passes_through_unretried(stubs, _env):
    bad, good = stubs("error_stream"), stubs()
    res = _same(run_both(_ordered("app error", bad, good),
                         lambda port, r: call(port, *_gen("app error")), _env))
    assert res[0] == 500 and good.calls == [] and b"Error from chain server." in res[2]


# --------------------------------------------------------------------------- #
# tests/test_router_handover.py's cases


def test_preempted_stream_restores_on_sibling_seamlessly(stubs, _env):
    drainer, sibling = stubs("preempt"), stubs("transcript")
    res = _same(run_both(_ordered("preempt probe", drainer, sibling),
                         lambda port, r: call(port, *_gen("preempt probe")), _env))
    assert res[0] == 200 and _client_text(res[2]) == "".join(TRANSCRIPT)
    assert b'"PREEMPTED"' not in res[2] and b'"[DONE]"' in res[2]
    assert ("GET", f"/internal/snapshots/{SID}") in drainer.calls
    assert sibling.calls == [("POST", "/internal/restore")]
    assert json.loads(sibling.bodies[0]) == drainer.doc
    assert sibling.req_headers[0]["X-GenAI-Restore"] == SID


def test_mid_stream_death_replays_on_sibling(stubs, _env):
    dying, sibling = stubs("die"), stubs("transcript")
    res = _same(run_both(_ordered("death probe", dying, sibling),
                         lambda port, r: call(port, *_gen("death probe")), _env))
    assert _client_text(res[2]) == "".join(TRANSCRIPT) and b'"[DONE]"' in res[2]
    assert sibling.calls == [("POST", "/generate")]


def test_refused_continuation_truncates_without_done(stubs, _env):
    drainer, sibling = stubs("preempt"), stubs("transcript", restore_status=409)
    res = _same(run_both(_ordered("refusal probe", drainer, sibling),
                         lambda port, r: call(port, *_gen("refusal probe")), _env))
    assert _client_text(res[2]) == "".join(PREFIX)
    assert b"scripted refusal" not in res[2] and b'"[DONE]"' not in res[2]


def test_last_upstream_error_passes_through_when_budget_spent(stubs, _env):
    a, b = (stubs("status", status=503, headers={"Retry-After": "7"}) for _ in range(2))
    res = _same(run_both([a, b], lambda port, r: call(port, *_gen("shed probe")), _env))
    assert res[0] == 503 and res[1]["Retry-After"] == "7" and b"scripted" in res[2]
    assert a.generate_calls() == 1 and b.generate_calls() == 1


def test_retry_budget_zero_disables_replacement(stubs, _env):
    drainer, sibling = stubs("preempt"), stubs("transcript")
    res = _same(run_both(_ordered("budget-zero probe", drainer, sibling),
                         lambda port, r: call(port, *_gen("budget-zero probe")), _env,
                         APP_ROUTER_RETRYBUDGET="0"))
    assert sibling.calls == [] and _client_text(res[2]) == "".join(PREFIX)


def test_budget_exhausted_with_unreachable_fleet_is_502(_env):
    def script(port, router):
        return call(port, *_gen("dead fleet probe"))

    dead = [type("Dead", (), {"url": u, "reset": lambda self: None, "calls": []})()
            for u in ("http://127.0.0.1:9", "http://127.0.0.1:13")]
    res = _same(run_both(dead, script, _env))
    assert res[0] == 502 and b"upstream replica failed" in res[2]


# --------------------------------------------------------------------------- #
# Port-only behaviour of the threaded proxy


def test_close_delimited_stream_cut_before_done_is_a_death(stubs, _env):
    """The port's servers end a stream by closing the connection: a close
    before ``[DONE]`` is bridged as a death, as a cut chunked body is."""
    dying, sibling = stubs("close_delimited"), stubs("transcript")
    for key, value in {"APP_ROUTER_HEALTHINTERVALS": "60"}.items():
        _env.setenv(key, value)
    router = PortRouter([s.url for s in _ordered("cut probe", dying, sibling)])
    try:
        status, _, body = call(router.port, *_gen("cut probe"))
    finally:
        router.close()
    assert status == 200 and _client_text(body) == "".join(TRANSCRIPT)
    assert sibling.calls == [("POST", "/generate")]


def test_client_that_goes_away_closes_the_upstream(_env):
    """A client disconnect mid-stream closes the router's upstream
    connection, which is what aborts the replica's engine request."""
    closed, started = threading.Event(), threading.Event()

    class Slow(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802
            data = b'{"ready": true}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Connection", "close")
            self.end_headers()
            started.set()
            try:
                for _ in range(200):
                    self.wfile.write(_frame("tok").encode())
                    self.wfile.flush()
                    time.sleep(0.05)
            except OSError:
                closed.set()
            self.close_connection = True

    upstream = ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    upstream.daemon_threads = True
    threading.Thread(target=upstream.serve_forever, name="slow-replica", daemon=True).start()
    _env.setenv("APP_ROUTER_HEALTHINTERVALS", "60")
    router = PortRouter([f"http://127.0.0.1:{upstream.server_address[1]}"])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=10)
        conn.request("POST", "/generate", body=json.dumps(
            {"messages": [{"role": "user", "content": "x"}]}).encode())
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read1(64)
        assert started.wait(5)
        resp.close()
        conn.close()
        assert closed.wait(10), "the upstream kept streaming to a gone client"
        deadline = time.time() + 5
        while router.router.monitor.inflight("r0") and time.time() < deadline:
            time.sleep(0.05)
        assert router.router.monitor.inflight("r0") == 0
    finally:
        router.close()
        upstream.shutdown()
        upstream.server_close()
