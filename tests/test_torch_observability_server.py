"""The observability surface of the port's two servers
(generativeaiexamples_tpu_torch/server/observability.py, server/api.py,
engine/server.py) and engine against the JAX package's, on the CPU.

- Route parity: the port serves exactly JAX's ``add_observability_routes``
  table plus ``/internal/metrics``, on both servers.
- Both port servers answer each route with JAX's status code, content
  type and JSON keys for the same requests (the JAX chain server through
  its aiohttp app, the JAX engine server's app likewise; malformed
  cursors and trace ids 400, unknown ids 404, profiling 403 while off),
  and a ``/generate`` with a ``traceparent`` leaves the same flight
  timeline (``http_request -> admitted -> finish``) under that trace id.
- Engine parity: the same prompts (greedy, made from a numpy seed)
  through the tiny JAX engine and the port's engine on the same weights:
  equal streams, equal deltas of the request-level families (requests,
  generated tokens, TTFT and queue-wait counts, prefill chunks, decode
  steps), equal record outcomes, and equal flight-event kind sequences.
  The release's events race the reader's finish in both packages (the
  dispatch thread frees a budget-exhausted slot while the reader emits
  the last tokens): ``decode_leave`` lands only while the rid is still
  mapped, and ``page_free`` before or after ``finish``; so the sequences
  are compared without the two, and ``page_free``'s count a record
  apart. The JAX-only kinds (none appear here,
  listed for the reader) are ``hot_path_compile`` (XLA compiles) and
  ``paged_kernel_fallback``.

Exact comparisons: no tolerance applies. Each test resets only the two
packages' flight recorders, never the JAX process registry."""
import json
import threading
import time

import numpy as np
import pytest
from aiohttp import web

from generativeaiexamples_tpu.server import observability as jobs
from generativeaiexamples_tpu.utils import blackbox as jbb
from generativeaiexamples_tpu.utils import flight_recorder as jfr
from generativeaiexamples_tpu_torch.server import observability as tobs
from generativeaiexamples_tpu_torch.utils import blackbox as tbb
from generativeaiexamples_tpu_torch.utils import flight_recorder as tfr
from tests.test_torch_chain_server import (  # noqa: F401 - app_env is a fixture
    JAX,
    PORT,
    _fresh_echo,
    _gen,
    _port_request,
    _Req,
    _run_jax,
    _run_port,
    app_env,
)

JAX_ONLY_KINDS = ("hot_path_compile", "paged_kernel_fallback")
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"


@pytest.fixture(autouse=True)
def _reset():
    for mod in (jfr, tfr):
        mod.reset()
    yield
    for mod in (jfr, tfr):
        mod.reset()
    # the servers' configure_from_config armed both black boxes: disarm them
    # and join their capture workers, so that no capture runs on into a
    # later test in this process
    for mod in (jbb, tbb):
        mod.drain()
        mod.reset()


def test_route_table_is_jax_s():
    app = web.Application()
    jobs.add_observability_routes(app)
    jax_routes = {(r.method, r.resource.canonical) for r in app.router.routes()
                  if r.method != "HEAD"}
    jax_routes.add(("GET", "/internal/metrics"))
    assert set(tobs.ROUTE_TABLE) == jax_routes
    assert len(tobs.ROUTE_TABLE) == len(jax_routes) == 10


def _requests():
    trace_hdr = {"traceparent": f"00-{TRACE}-00f067aa0ba902b7-01"}
    return [
        _Req("POST", "/generate", {"messages": [{"role": "user", "content": "hi there"}],
                                   "use_knowledge_base": False}, headers=trace_hdr),
        _Req("GET", "/internal/requests"),
        _Req("GET", f"/internal/requests?trace={TRACE}"),
        _Req("GET", "/internal/requests?trace=nothex"),
        _Req("GET", "/internal/requests?trace="),
        _Req("GET", "/internal/requests?since=0&limit=5"),
        _Req("GET", "/internal/requests?since=x"),
        _Req("GET", "/internal/requests?slow=1"),
        _Req("GET", "/internal/requests/nope"),
        _Req("GET", "/internal/timeline"),
        _Req("GET", "/internal/timeline?since=x"),
        _Req("GET", "/internal/timeline?format=perfetto&since=0"),
        _Req("GET", "/internal/slo"),
        _Req("GET", "/internal/debug/bundles"),
        _Req("GET", "/internal/debug/bundles/nope"),
        _Req("POST", "/internal/profile/start", raw=b""),
        _Req("POST", "/internal/profile/stop", raw=b""),
        _Req("GET", "/internal/metrics"),
        _Req("GET", "/metrics"),
        _Req("GET", "/metrics", headers={"Accept": "application/openmetrics-text"}),
        _Req("DELETE", "/internal/slo"),
    ]


def _keys(status, headers, body):
    ctype = headers.get("Content-Type", "")
    out = [status, ctype.split(";")[0]]
    if ctype.startswith("application/json"):
        doc = json.loads(body)
        out.append(sorted(doc) if isinstance(doc, dict) else type(doc).__name__)
    return out


def _trace_kinds(body):
    (tl,) = json.loads(body)["timelines"]
    return [e["event"] for e in tl["timeline"]], tl["trace_id"], tl["outcome"]


@pytest.fixture
def traced(monkeypatch):
    """Both packages' tracers on, exporting to memory; the process
    tracers are put back (built lazily again) afterwards."""
    from generativeaiexamples_tpu.utils import tracing as jt
    from generativeaiexamples_tpu_torch.utils import tracing as tt

    monkeypatch.setenv("ENABLE_TRACING", "true")
    monkeypatch.setenv("TRACE_EXPORTER", "memory")
    saved = (jt._TRACER, tt._TRACER)
    jt._TRACER = tt._TRACER = None
    yield tt
    for mod, old in ((jt, saved[0]), (tt, saved[1])):
        mod.get_tracer().shutdown()
        mod._TRACER = old


def test_chain_server_answers_as_jax_s(app_env, traced, monkeypatch):
    monkeypatch.delenv("ENABLE_PROFILING", raising=False)
    want = _run_jax(_fresh_echo(JAX), _requests())
    got = _run_port(_fresh_echo(PORT), _requests())
    for (req, w, g) in zip(_requests(), want, got):
        assert _keys(*g) == _keys(*w), (req.method, req.path)
    assert got[0][2].endswith(b'"[DONE]"}\n\n') or b"[DONE]" in got[0][2]
    assert _trace_kinds(got[2][2]) == _trace_kinds(want[2][2]) == (
        ["http_request", "admitted", "finish"], TRACE, "finish")
    families = {line.split()[2] for line in got[18][2].decode().splitlines()
                if line.startswith("# TYPE")}
    assert "genai_http_requests_total" in families and "genai_engine_ttft_seconds" in families
    assert got[19][2].decode().endswith("# EOF\n")
    tracer = traced.get_tracer()
    tracer.force_flush()
    spans = {(sp.name, f"{sp.context.trace_id:032x}") for sp in tracer.exporter.spans}
    assert ("POST /generate", TRACE) in spans


def _http_counts(body: bytes) -> dict:
    out = {}
    for line in body.decode().splitlines():
        if line.startswith("genai_http_requests_total{"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def test_request_detail_and_accounting(app_env):
    """``/internal/requests/{id}`` serves the record by id, and requests
    count under their route pattern (a path no route serves, or a method
    none serves, under ``unmatched``) in both packages alike; counts are
    read as deltas (the registries are process-wide)."""
    out = {}
    for run, pkg in ((_run_jax, JAX), (_run_port, PORT)):
        reqs = [_Req("GET", "/metrics"), _gen("one"), _Req("GET", "/internal/requests?since=0")]
        first = run(_fresh_echo(pkg), reqs)
        rid = json.loads(first[2][2])["timelines"][0]["request_id"]
        second = run(_fresh_echo(pkg), [_Req("GET", f"/internal/requests/{rid}"),
                                        _Req("GET", "/no/such/route"),
                                        _Req("DELETE", "/internal/slo"), _Req("GET", "/metrics")])
        detail = json.loads(second[0][2])
        before, after = _http_counts(first[0][2]), _http_counts(second[3][2])
        delta = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
        out[pkg is PORT] = (second[0][0], sorted(detail), [e["event"] for e in detail["timeline"]],
                            second[1][0], second[2][0], delta)
    assert out[True] == out[False]
    assert out[True][5] == {
        'genai_http_requests_total{route="/metrics",method="GET",status="200"}': 1.0,
        'genai_http_requests_total{route="/generate",method="POST",status="200"}': 1.0,
        'genai_http_requests_total{route="/internal/requests",method="GET",status="200"}': 1.0,
        'genai_http_requests_total{route="/internal/requests/{id}",method="GET",status="200"}':
            1.0,
        'genai_http_requests_total{route="unmatched",method="GET",status="404"}': 1.0,
        'genai_http_requests_total{route="unmatched",method="DELETE",status="405"}': 1.0,
    }


def _engine_server_requests():
    return [_Req("GET", "/metrics"), _Req("GET", "/internal/metrics"),
            _Req("GET", "/internal/requests"), _Req("GET", "/internal/timeline"),
            _Req("GET", "/internal/slo"), _Req("GET", "/internal/debug/bundles"),
            _Req("POST", "/internal/profile/stop", raw=b""),
            _Req("GET", "/internal/requests/7")]


def test_engine_server_answers_as_jax_s(monkeypatch):
    """Both engine servers, with no engine built: the same statuses and
    keys, and neither builds an engine to answer."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from generativeaiexamples_tpu.engine import server as jserver
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine.server import make_server

    monkeypatch.delenv("ENABLE_PROFILING", raising=False)
    monkeypatch.setattr(llm_engine, "_ENGINE", None)

    async def run_jax():
        async with TestClient(TestServer(jserver.ModelServer().build_app())) as client:
            out = []
            for r in _engine_server_requests():
                resp = await client.request(r.method, r.path, data=r.raw, headers=r.headers)
                out.append((resp.status, dict(resp.headers), await resp.read()))
            return out

    want = asyncio.run(run_jax())
    server = make_server(port=0)
    thread = threading.Thread(target=server.serve_forever, name="test-engine-server",
                              daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        got = [_port_request(base, r) for r in _engine_server_requests()]
        assert server.RequestHandlerClass.app._engine is None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    for req, w, g in zip(_engine_server_requests(), want, got):
        assert _keys(*g) == _keys(*w), req.path


# --------------------------------------------------------------------- #
# Engine parity


RELEASE_KINDS = ("decode_leave", "page_free")


def _kinds(mod):
    tls = list(reversed(mod.recent_timelines(32)))
    seqs = [[e["event"] for e in tl["timeline"] if e["event"] not in RELEASE_KINDS]
            for tl in tls]
    frees = [sum(e["event"] == "page_free" for e in tl["timeline"]) for tl in tls]
    return seqs, frees


def test_engine_families_and_flight_events_are_jax_s():
    import jax.numpy as jnp

    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine import llm_engine as jeng
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine import llm_engine as teng
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(model_config_name="debug", max_batch_size=2, max_seq_len=128, prefill_chunk=16,
                  dtype="float32", page_size=16, kv_layout="paged")
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(3, 250, size=n)) for n in (5, 37, 9, 20)]
    fams = ("_M_REQUESTS", "_M_TOKENS", "_M_PREFILL_CHUNKS", "_M_DECODE_STEPS", "_M_WAVES")
    hists = ("_M_TTFT", "_M_QUEUE_WAIT", "_M_PREFILL_WAIT")

    def snap(mod):
        out = {f: getattr(mod, f).value for f in fams}
        out.update({h: getattr(mod, h).count for h in hists})
        return out

    jax_engine = jeng.LLMEngine(JaxEngineConfig(tensor_parallelism=1, serving_layout="layered",
                                                **common))
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = teng.LLMEngine(EngineConfig(**common), device="cpu", params=params_from_jax(weights))
    try:
        j0, t0 = snap(jeng), snap(teng)
        for prompt in prompts:
            want = list(jax_engine.iter_ids([int(x) for x in prompt],
                                            jeng.SamplingParams(temperature=0.0, max_tokens=6),
                                            timeout=600))
            got = list(port.iter_ids([int(x) for x in prompt],
                                     teng.SamplingParams(temperature=0.0, max_tokens=6),
                                     timeout=600))
            assert got == want
        deadline = time.time() + 30
        while (len(jfr.recent_timelines(32)) < len(prompts)
               or len(tfr.recent_timelines(32)) < len(prompts)):
            assert time.time() < deadline
            time.sleep(0.01)
        j1, t1 = snap(jeng), snap(teng)
        assert {k: t1[k] - t0[k] for k in t1} == {k: j1[k] - j0[k] for k in j1}
        assert [tl["outcome"] for tl in tfr.recent_timelines(32)] == [
            tl["outcome"] for tl in jfr.recent_timelines(32)]
        (jk, jfree), (tk, tfree) = _kinds(jfr), _kinds(tfr)
        assert not {k for seq in jk for k in seq} & set(JAX_ONLY_KINDS)
        assert tk == jk and tfree == jfree
        assert tk[1][:4] == ["submit", "admit", "page_alloc", "prefill_chunk"]
    finally:
        jax_engine.shutdown()
        port.shutdown()
