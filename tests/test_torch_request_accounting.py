"""The port's three HTTP servers count a non-streamed reply before its
bytes go out, as JAX's aiohttp ``metrics_middleware`` does (the handler
returns the response, the middleware's ``finally`` counts it, then aiohttp
writes it): a ``/metrics`` scrape sent right after a reply never misses it.

Deterministic, no race needed: each case wraps the handler's header
writer (``end_headers``, which puts the status line and headers on the
wire before the body) so that it reads ``genai_http_requests_total`` for
the request's own route at that moment. Counts are read as deltas (the
registry is process-wide).
"""
import http.client
import threading

import pytest

from generativeaiexamples_tpu_torch.server import observability as tobs
from tests.test_torch_chain_server import app_env  # noqa: F401 - a fixture


def _count(route, method, status):
    return tobs.HTTP_REQUESTS.labels(route=route, method=method, status=str(status)).value


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, name="test-accounting", daemon=True)
    thread.start()
    return thread


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _chain_server():
    from generativeaiexamples_tpu_torch.chains.echo import EchoChain
    from generativeaiexamples_tpu_torch.server import api

    return api._Handler, api.make_server("127.0.0.1", 0, EchoChain), None, "/health"


def _engine_server():
    from generativeaiexamples_tpu_torch.engine import server

    # /v1/health/ready answers without building an engine
    return server._Handler, server.make_server("127.0.0.1", 0), None, "/v1/health/ready"


def _router():
    from generativeaiexamples_tpu_torch.config import AppConfig
    from generativeaiexamples_tpu_torch.router import app

    router = app.RouterServer(AppConfig.from_env(), replica_urls=["http://127.0.0.1:9"])
    return app._Handler, router.build_server("127.0.0.1", 0), router, "/internal/fleet"


@pytest.mark.parametrize("build", [_chain_server, _engine_server, _router],
                         ids=["chain_server", "engine_server", "router"])
def test_a_reply_is_counted_before_its_bytes_go_out(app_env, monkeypatch, build):  # noqa: F811
    handler_cls, server, router, path = build()
    seen = []
    write_headers = handler_cls.end_headers

    def spy(self):
        seen.append(_count(path, "GET", 200))
        write_headers(self)

    monkeypatch.setattr(handler_cls, "end_headers", spy)
    before = _count(path, "GET", 200)
    thread = _serve(server)
    try:
        status, _ = _get(server.server_address[1], path)
    finally:
        if router is not None:
            router.stop()
        server.shutdown()
        server.server_close()
        thread.join(30)
    assert status == 200
    # the request's own count had moved when its headers went out
    assert seen == [before + 1]
    assert _count(path, "GET", 200) == before + 1
