"""The HTTP surface the experimental apps share, on the standard library's
``ThreadingHTTPServer`` (one thread per connection).

The JAX apps are aiohttp applications; this keeps what a client of theirs
sees: JSON bodies as ``json.dumps`` writes them with ``application/json;
charset=utf-8``, ``404: Not Found`` for an unknown path, ``405: Method Not
Allowed`` with ``Allow`` (a GET route also answers HEAD) for a known path
and another method, and aiohttp's plain-text 500 when a handler raises
before its reply started (a body that is no JSON, for instance).
"""
from __future__ import annotations

import json
import logging
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

JSON_TYPE = "application/json; charset=utf-8"
TEXT_TYPE = "text/plain; charset=utf-8"
INTERNAL_ERROR = b"500 Internal Server Error\n\nServer got itself in trouble"


class Reply(Exception):
    """A complete answer: raised or returned by a route."""

    def __init__(self, status: int, body: bytes, content_type: str = JSON_TYPE,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(status)
        self.status, self.body, self.content_type = status, body, content_type
        self.headers = headers or {}


def json_reply(obj, status: int = 200) -> Reply:
    return Reply(status, json.dumps(obj).encode())


Route = Callable[["AppHandler"], Optional[Reply]]


class AppHandler(BaseHTTPRequestHandler):
    """Dispatch by (method, path) to ``routes``; a route returns a
    ``Reply`` or answers itself (a stream) and returns None."""

    protocol_version = "HTTP/1.1"
    routes: Dict[Tuple[str, str], Route] = {}  # set on the subclass
    _streaming = False

    def log_message(self, fmt, *args):  # access logs through logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0") or 0)
        return self.rfile.read(n) if n > 0 else b""

    def json(self):
        """The request's JSON body (anything else raises: a 500)."""
        return json.loads(self.body().decode("utf-8"))

    def reply(self, r: Reply, head_only: bool = False) -> None:
        self.send_response(r.status)
        self.send_header("Content-Type", r.content_type)
        self.send_header("Content-Length", str(len(r.body)))
        for name, value in r.headers.items():
            self.send_header(name, value)
        self.end_headers()
        if not head_only:
            self.wfile.write(r.body)

    def start_stream(self, headers: Dict[str, str]) -> None:
        """200 with ``headers``; the body runs until the connection closes."""
        self._streaming = True
        self.send_response(200)
        for name, value in headers.items():
            self.send_header(name, value)
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

    def write(self, data: bytes) -> None:
        self.wfile.write(data)
        self.wfile.flush()

    def _serve(self, method: str) -> None:
        path = urllib.parse.urlsplit(self.path).path
        lookup = "GET" if method == "HEAD" else method
        route = self.routes.get((lookup, path))
        try:
            if route is None:
                allowed = sorted({m for (m, p) in self.routes if p == path}
                                 | ({"HEAD"} if ("GET", path) in self.routes else set()))
                if allowed:
                    raise Reply(405, b"405: Method Not Allowed", TEXT_TYPE,
                                {"Allow": ",".join(allowed)})
                raise Reply(404, b"404: Not Found", TEXT_TYPE)
            result = route(self)
            if result is not None:
                self.reply(result, head_only=method == "HEAD")
        except Reply as r:
            if r.status >= 400:  # the body may be unread: no second request on this connection
                self.close_connection = True
            self.reply(r, head_only=method == "HEAD")
        except Exception:  # noqa: BLE001 - aiohttp's answer to a handler that raised
            logger.exception("Error handling request %s %s", method, path)
            if self._streaming:
                raise
            self.reply(Reply(500, INTERNAL_ERROR, TEXT_TYPE), head_only=method == "HEAD")
            self.close_connection = True

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._serve("GET")

    def do_HEAD(self):  # noqa: N802
        self._serve("HEAD")

    def do_POST(self):  # noqa: N802
        self._serve("POST")

    def do_PUT(self):  # noqa: N802
        self._serve("PUT")

    def do_DELETE(self):  # noqa: N802
        self._serve("DELETE")


def make_app_server(routes: Dict[Tuple[str, str], Route], host: str, port: int,
                    name: str) -> ThreadingHTTPServer:
    """A bound, not yet serving, server of ``routes`` (``port=0`` picks a
    free port: ``server_address``)."""
    handler = type(name, (AppHandler,), {"routes": dict(routes)})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server
