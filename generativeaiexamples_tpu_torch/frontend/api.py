"""The playground frontend server.

Counterpart of generativeaiexamples_tpu/frontend/api.py on the standard
library's ``http.server.ThreadingHTTPServer`` (the JAX server is aiohttp),
with its routes, status codes and bodies: it serves the two pages and
proxies ``/api/*`` to the chain server (or the router in front of a
fleet) so the browser has a same-origin target. ``/api/generate`` is
forwarded as it arrives (``HTTPResponse.read1``), never buffered. Speech
(ASR/TTS) rides any OpenAI-compatible ``/v1/audio`` service — see
speech.py; controls appear when ``APP_SPEECH_SERVERURL`` is set. The
frontend is host-only.
"""
from __future__ import annotations

import http.client
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from generativeaiexamples_tpu_torch.frontend import pages
from generativeaiexamples_tpu_torch.frontend.chat_client import ChatClient
from generativeaiexamples_tpu_torch.utils import multipart
from generativeaiexamples_tpu_torch.utils.logging import get_logger
from generativeaiexamples_tpu_torch.utils.resilience import URL_ERRORS
from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

logger = get_logger(__name__)

#: ``(status, headers, body)`` of an answer
Response = Tuple[int, Dict[str, str], bytes]
JSON_TYPE = "application/json; charset=utf-8"
MAX_BODY = 512 * 1024 * 1024
_UNREACHABLE_FRAME = (
    b'data: {"choices": [{"index": 0, "message": {"role": "assistant", '
    b'"content": "Error: chain-server unreachable."}, '
    b'"finish_reason": "[DONE]"}]}\n\n'
)


def _json(body, status: int = 200) -> Response:
    return status, {"Content-Type": JSON_TYPE}, json.dumps(body).encode()


class FrontendServer:
    def __init__(self, chain_server_url: str = ""):
        from generativeaiexamples_tpu_torch.frontend.speech import ASRClient, TTSClient

        self._client = ChatClient(chain_server_url or None)
        self.chain_server_url = self._client.server_url
        # Speech lights up when APP_SPEECH_SERVERURL points at any
        # OpenAI-compatible /v1/audio service.
        self.asr = ASRClient()
        self.tts = TTSClient()

    def build_server(self, host: str = "127.0.0.1", port: int = 0) -> ThreadingHTTPServer:
        """A bound, not yet serving, server (``port=0`` picks a free
        port, ``server_address``)."""
        handler = type("Handler", (_Handler,), {"frontend": self})
        server = ThreadingHTTPServer((host, port), handler)
        server.daemon_threads = True
        return server

    # -- upstream --------------------------------------------------------
    def _upstream(self, method: str, path: str, body: Optional[bytes],
                  headers: Dict[str, str], timeout: float):
        """``(connection, response)`` of one request to the chain server;
        the caller closes the connection."""
        url = urllib.parse.urlsplit(self.chain_server_url)
        cls = http.client.HTTPSConnection if url.scheme == "https" else http.client.HTTPConnection
        conn = cls(url.hostname, url.port, timeout=timeout)
        try:
            conn.request(method, url.path.rstrip("/") + path, body=body, headers=headers)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    def _forward(self, method: str, path: str, body: Optional[bytes],
                 headers: Dict[str, str], timeout: float) -> Response:
        """The chain server's answer as a JSON :data:`Response`; 502 when
        it cannot be reached."""
        try:
            conn, upstream = self._upstream(method, path, body, headers, timeout)
            try:
                payload = upstream.read()
            finally:
                conn.close()
        except URL_ERRORS as exc:
            logger.error("chain-server unreachable: %s", exc)
            return _json({"message": "chain-server unreachable"}, 502)
        return upstream.status, {"Content-Type": "application/json"}, payload

    def _proxy_json(self, method: str, path: str, h: "_Handler",
                    data: Optional[bytes] = None) -> Response:
        """Forward the request's query, body (or ``data``) and
        Content-Type."""
        query = urllib.parse.urlsplit(h.path).query
        ctype = h.headers.get("Content-Type")
        return self._forward(method, path + (f"?{query}" if query else ""),
                             data if data is not None else h.body(),
                             {"Content-Type": ctype} if ctype else {}, 300.0)

    # -- routes ----------------------------------------------------------
    def proxy_generate(self, h: "_Handler") -> None:
        """Stream /generate SSE through without buffering."""
        body = h.body()
        headers = get_tracer().inject({"Content-Type": "application/json"})
        h.start_stream()
        try:
            conn, upstream = self._upstream("POST", "/generate", body, headers, 600.0)
        except URL_ERRORS as exc:
            logger.error("chain-server unreachable: %s", exc)
            h.write(_UNREACHABLE_FRAME)
            return
        try:
            while True:
                chunk = upstream.read1(64 * 1024)
                if not chunk:
                    return
                h.write(chunk)
        except URL_ERRORS as exc:
            if h.client_gone:
                return  # the browser went away: closing the upstream aborts the answer
            logger.error("chain-server unreachable: %s", exc)
            h.write(_UNREACHABLE_FRAME)
        finally:
            conn.close()

    def proxy_upload(self, h: "_Handler") -> Response:
        """Re-pack the browser's multipart form for the chain server."""
        found = multipart.file_field(h.headers.get("Content-Type", ""), h.body())
        if found is None:
            return _json({"message": "No files provided"})
        body, ctype = multipart.encode(files={"file": found})
        return self._forward("POST", "/documents", body, {"Content-Type": ctype}, 600.0)

    def speech_status(self, h: "_Handler") -> Response:
        """The converse page probes this to decide whether to render the
        mic/speaker controls."""
        return _json({"asr": self.asr.available, "tts": self.tts.available})

    def transcribe(self, h: "_Handler") -> Response:
        """Browser mic recording (multipart ``file``) -> transcript."""
        from generativeaiexamples_tpu_torch.frontend.speech import SpeechUnavailable

        found = multipart.file_field(h.headers.get("Content-Type", ""), h.body())
        if found is None:
            return _json({"message": "No audio provided"}, 422)
        filename, audio = found
        try:
            text = self.asr.transcribe(audio, filename)
        except SpeechUnavailable as exc:
            return _json({"message": str(exc)}, 503)
        except Exception as exc:  # noqa: BLE001 - surface upstream failure
            logger.error("ASR backend failed: %s", exc)
            return _json({"message": "speech service error"}, 502)
        return _json({"text": text})

    def speak(self, h: "_Handler") -> Response:
        """JSON ``{"text": ...}`` -> synthesized audio bytes."""
        from generativeaiexamples_tpu_torch.frontend.speech import SpeechUnavailable

        try:
            body = json.loads(h.body())
        except ValueError:
            return _json({"message": "invalid JSON"}, 422)
        text = (body.get("text") or "").strip()
        if not text:
            return _json({"message": "empty text"}, 422)
        try:
            audio = self.tts.synthesize(text)
        except SpeechUnavailable as exc:
            return _json({"message": str(exc)}, 503)
        except Exception as exc:  # noqa: BLE001 - surface upstream failure
            logger.error("TTS backend failed: %s", exc)
            return _json({"message": "speech service error"}, 502)
        return 200, {"Content-Type": "audio/mpeg"}, audio

    def routes(self):
        """``{(method, path): handler}``; a handler takes the request
        handler and answers a :data:`Response`, or None once it has
        streamed its answer."""
        html = {"Content-Type": "text/html; charset=utf-8"}
        return {
            ("GET", "/"): lambda h: (302, {"Content-Type": "text/plain; charset=utf-8",
                                           "Location": "/content/converse"}, b"302: Found"),
            ("GET", "/content/converse"): lambda h: (200, html, pages.CONVERSE_HTML.encode()),
            ("GET", "/content/kb"): lambda h: (200, html, pages.KB_HTML.encode()),
            ("POST", "/api/generate"): self.proxy_generate,
            ("POST", "/api/search"): lambda h: self._proxy_json("POST", "/search", h),
            ("GET", "/api/documents"): lambda h: self._proxy_json("GET", "/documents", h, b""),
            ("POST", "/api/documents"): self.proxy_upload,
            ("DELETE", "/api/documents"): lambda h: self._proxy_json("DELETE", "/documents", h,
                                                                     b""),
            ("GET", "/api/speech/status"): self.speech_status,
            ("POST", "/api/transcribe"): self.transcribe,
            ("POST", "/api/speak"): self.speak,
            ("GET", "/health"): lambda h: _json({"message": "Service is up."}),
        }


class _Handler(BaseHTTPRequestHandler):
    server_version = "genai-torch-frontend/1"
    protocol_version = "HTTP/1.1"
    frontend: FrontendServer  # set on the subclass build_server makes
    client_gone = False
    _raw: Optional[bytes] = None

    def log_message(self, fmt, *args):  # access logs through logging
        logger.debug("%s " + fmt, self.address_string(), *args)

    def reply(self, resp: Response) -> None:
        status, headers, body = resp
        self.send_response(status)
        for name, value in headers.items():
            self.send_header(name, value)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.write(body)

    def start_stream(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True

    def write(self, data: bytes) -> None:
        try:
            self.wfile.write(data)
            self.wfile.flush()
        except OSError:
            self.client_gone = True
            raise

    def body(self) -> bytes:
        if self._raw is None:
            n = int(self.headers.get("Content-Length", "0") or 0)
            self._raw = self.rfile.read(min(n, MAX_BODY)) if n > 0 else b""
        return self._raw

    def _serve(self, method: str) -> None:
        self._raw = None
        path = urllib.parse.urlsplit(self.path).path
        routes = self.frontend.routes()
        route = routes.get((method, path))
        try:
            if route is None:
                allowed = [m for (m, p) in routes if p == path]
                if allowed:
                    self.reply((405, {"Content-Type": "text/plain; charset=utf-8",
                                      "Allow": ",".join(allowed)}, b"405: Method Not Allowed"))
                else:
                    self.reply((404, {"Content-Type": "text/plain; charset=utf-8"},
                                b"404: Not Found"))
                return
            result = route(self)
            if result is not None:
                self.reply(result)
            if self._raw is None and method != "GET":
                self.body()
        except OSError:
            if not self.client_gone:
                raise
            logger.info("client disconnected from %s %s", method, path)
            self.close_connection = True

    def do_GET(self):  # noqa: N802 - http.server's naming
        self._serve("GET")

    def do_POST(self):  # noqa: N802
        self._serve("POST")

    def do_DELETE(self):  # noqa: N802
        self._serve("DELETE")


def create_frontend_server(chain_server_url: str = "", host: str = "127.0.0.1",
                           port: int = 0) -> ThreadingHTTPServer:
    return FrontendServer(chain_server_url).build_server(host, port)
