"""The port's playground frontend (generativeaiexamples_tpu_torch/frontend/)
against the JAX package's, on the CPU.

- Pages: the HTML constants and the served pages are byte-equal to JAX's,
  and ``/`` redirects to the converse page alike.
- Proxies: both frontends in front of one standard-library stub chain
  server (SSE ``/generate`` with multibyte and replacement characters in
  chunked framing, ``/search``, ``/documents``): every ``/api/*`` route
  answers with JAX's status, content type and body, and the stub receives
  the same requests (method, path and query, JSON body, the uploaded
  file's name and bytes); with the chain server down, ``/api/generate``
  streams JAX's error frame and the JSON proxies answer JAX's 502.
- ``ChatClient``: ``predict`` yields the same chunks from the same SSE (and
  stops at ``[DONE]``), ``search``, ``get_uploaded_documents``,
  ``delete_documents`` and ``upload_documents`` give and send the same.
- Speech: unconfigured clients raise JAX's messages and the routes answer
  JAX's 503 and 422s; configured against a stub audio service, both
  clients send the same form fields and JSON and return the same text and
  bytes.

Exact comparisons: no tolerance applies."""
import asyncio
import http.client
import json
import threading
import urllib.parse
from email.parser import BytesParser
from email.policy import HTTP
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from aiohttp import web

from generativeaiexamples_tpu.frontend import pages as jpages
from generativeaiexamples_tpu.frontend import speech as jspeech
from generativeaiexamples_tpu.frontend.api import create_frontend_app
from generativeaiexamples_tpu.frontend.chat_client import ChatClient as JChatClient
from generativeaiexamples_tpu_torch.frontend import pages as tpages
from generativeaiexamples_tpu_torch.frontend import speech as tspeech
from generativeaiexamples_tpu_torch.frontend.api import create_frontend_server
from generativeaiexamples_tpu_torch.frontend.chat_client import ChatClient as TChatClient

ANSWER = ["Hé", "llo ", "wörld �", "!"]


def _frame(content="", finish=""):
    return ("data: " + json.dumps({"id": "x", "choices": [{
        "index": 0, "message": {"role": "assistant", "content": content},
        "finish_reason": finish}]}) + "\n\n").encode()


def _parts(content_type, body):
    """{field name: (filename or None, bytes)} of a multipart body."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    return {p.get_param("name", header="content-disposition"):
            (p.get_filename(), p.get_payload(decode=True)) for p in msg.iter_parts()}


class Stub:
    """A chain server (and an audio service) recording what it receives."""

    def __init__(self):
        self.got = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, status, ctype, data):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _record(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("multipart/form-data"):
                    body = _parts(ctype, body)
                    ctype = "multipart/form-data"
                stub.got.append((self.command, self.path, ctype, body))
                return body

            def do_GET(self):  # noqa: N802
                self._record()
                if self.path.startswith("/documents"):
                    return self._reply(200, "application/json", b'{"documents": ["a.txt"]}')
                return self._reply(404, "text/plain", b"nope")

            def do_DELETE(self):  # noqa: N802
                self._record()
                return self._reply(200, "application/json", b'{"message": "deleted"}')

            def do_POST(self):  # noqa: N802
                body = self._record()
                path = urllib.parse.urlsplit(self.path).path
                if path == "/generate":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for f in [b": comment\n\n", _frame(ANSWER[0]), b"data: not json\n\n"] + [
                            _frame(c) for c in ANSWER[1:]] + [_frame(finish="[DONE]"),
                                                              _frame("after done")]:
                        self.wfile.write(b"%x\r\n%s\r\n" % (len(f), f))
                    self.wfile.write(b"0\r\n\r\n")
                    return None
                if path == "/search":
                    q = json.loads(body)
                    return self._reply(200, "application/json", json.dumps({"chunks": [
                        {"content": q["query"], "filename": "a.txt", "score": 0.5}]}).encode())
                if path == "/documents":
                    return self._reply(200, "application/json", b'{"message": "ingested"}')
                if path == "/v1/audio/transcriptions":
                    return self._reply(200, "application/json", b'{"text": "heard"}')
                if path == "/v1/audio/speech":
                    return self._reply(200, "audio/mpeg", b"ID3-audio")
                return self._reply(404, "text/plain", b"nope")

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, name="stub-chain",
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


class JaxFrontend:
    def __init__(self, url):
        app = create_frontend_app(url)
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

        self.thread = threading.Thread(target=run, name="jax-frontend", daemon=True)
        self.thread.start()
        assert ready.wait(30)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


class PortFrontend:
    def __init__(self, url):
        self.server = create_frontend_server(url)
        self.port = self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever, name="port-frontend",
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.getheader("Location"), resp.read()
    finally:
        conn.close()


def _multipart(field, filename, data):
    boundary = "b0undary"
    body = (f'--{boundary}\r\nContent-Disposition: form-data; name="{field}"; '
            f'filename="{filename}"\r\nContent-Type: text/plain\r\n\r\n').encode() + data + (
        f"\r\n--{boundary}--\r\n").encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}"}


REQUESTS = [
    ("GET", "/", None, {}),
    ("GET", "/content/converse", None, {}),
    ("GET", "/content/kb", None, {}),
    ("GET", "/health", None, {}),
    ("GET", "/api/speech/status", None, {}),
    ("POST", "/api/generate", json.dumps({"messages": [{"role": "user", "content": "hi"}],
                                          "use_knowledge_base": False}).encode(),
     {"Content-Type": "application/json"}),
    ("POST", "/api/search", json.dumps({"query": "frontend proxy", "top_k": 2}).encode(),
     {"Content-Type": "application/json"}),
    ("GET", "/api/documents", None, {}),
    ("POST", "/api/documents", *_multipart("file", "notes.txt", b"tpu rag \xc3\xa9 notes")),
    ("POST", "/api/documents", *_multipart("other", "x.txt", b"no file field")),
    ("DELETE", "/api/documents?filename=notes.txt", None, {}),
    ("POST", "/api/transcribe", *_multipart("file", "a.webm", b"\x00audio")),
    ("POST", "/api/transcribe", *_multipart("nofile", "a.webm", b"x")),
    ("POST", "/api/speak", json.dumps({"text": "say this"}).encode(), {}),
    ("POST", "/api/speak", json.dumps({"text": "  "}).encode(), {}),
    ("POST", "/api/speak", b"not json", {}),
]


def _both(url, requests, monkeypatch, speech_url=None):
    if speech_url:
        monkeypatch.setenv("APP_SPEECH_SERVERURL", speech_url)
    else:
        monkeypatch.delenv("APP_SPEECH_SERVERURL", raising=False)
    out = []
    for cls in (JaxFrontend, PortFrontend):
        fe = cls(url)
        try:
            out.append([call(fe.port, *r) for r in requests])
        finally:
            fe.close()
    return out


@pytest.fixture
def stub():
    s = Stub()
    yield s
    s.close()


def test_pages_are_byte_equal():
    assert tpages.CONVERSE_HTML == jpages.CONVERSE_HTML
    assert tpages.KB_HTML == jpages.KB_HTML


@pytest.mark.parametrize("speech", [False, True], ids=["no_speech", "speech"])
def test_routes_answer_as_jax_s_and_send_the_same_upstream(stub, monkeypatch, speech):
    got = []

    def run(cls):
        stub.got.clear()
        fe = cls(stub.url)
        try:
            answers = [call(fe.port, *r) for r in REQUESTS]
        finally:
            fe.close()
        got.append(list(stub.got))
        return answers

    if speech:
        monkeypatch.setenv("APP_SPEECH_SERVERURL", stub.url)
    else:
        monkeypatch.delenv("APP_SPEECH_SERVERURL", raising=False)
    want, have = run(JaxFrontend), run(PortFrontend)
    for req, w, h in zip(REQUESTS, want, have):
        assert h == w, req[:2]
    # the stub got the same requests but for the client's own defaults
    # (aiohttp names a body-less GET's type; the upload's form field order)
    norm = [[(m, p, "" if ct == "application/octet-stream" else ct, b) for m, p, ct, b in g]
            for g in got]
    assert norm[1] == norm[0]
    sse = want[5][3]
    assert b"data: not json" in sse and "after done".encode() in sse


def test_generate_and_json_proxies_degrade_as_jax_s_when_the_chain_server_is_down(monkeypatch):
    requests = [REQUESTS[5], REQUESTS[6], REQUESTS[7], REQUESTS[8], REQUESTS[10]]
    want, have = _both("http://127.0.0.1:9", requests, monkeypatch)
    assert have == want
    assert b"unreachable" in want[0][3] and want[1][0] == 502


def test_chat_client_parses_the_same_sse(stub, tmp_path):
    doc = tmp_path / "notes.txt"
    doc.write_bytes(b"kb \xc3\xa9 content")
    out = []
    for cls in (JChatClient, TChatClient):
        stub.got.clear()
        client = cls(stub.url)
        chunks = list(client.predict("hello", chat_history=[{"role": "assistant", "content": "x"}],
                                     temperature=0.2))
        found = client.search("proxy", top_k=3)
        docs = client.get_uploaded_documents()
        deleted = client.delete_documents("notes.txt")
        client.upload_documents([str(doc)])
        received = [(m, p, b) for m, p, _, b in stub.got]
        out.append((chunks, found, docs, deleted, received))
    assert out[1] == out[0]
    assert "".join(out[0][0]) == "".join(ANSWER)


def test_chat_client_server_url_from_the_environment(monkeypatch):
    monkeypatch.setenv("APP_SERVERURL", "http://chain")
    monkeypatch.setenv("APP_SERVERPORT", "8081")
    assert TChatClient().server_url == JChatClient().server_url == "http://chain:8081"
    assert TChatClient("http://x:1/").server_url == JChatClient("http://x:1/").server_url


def test_unconfigured_speech_raises_jax_s_messages(monkeypatch):
    monkeypatch.delenv("APP_SPEECH_SERVERURL", raising=False)
    for make, call_ in ((lambda m: m.ASRClient(), lambda c: c.transcribe(b"x")),
                        (lambda m: m.TTSClient(), lambda c: c.synthesize("x"))):
        with pytest.raises(jspeech.SpeechUnavailable) as je:
            call_(make(jspeech))
        with pytest.raises(tspeech.SpeechUnavailable) as te:
            call_(make(tspeech))
        assert str(te.value) == str(je.value)
        assert make(tspeech).available is make(jspeech).available is False


def test_configured_speech_clients_send_and_return_the_same(stub, monkeypatch):
    monkeypatch.setenv("APP_SPEECH_ASRMODEL", "whisper-x")
    out = []
    for mod in (jspeech, tspeech):
        stub.got.clear()
        asr, tts = mod.ASRClient(stub.url, language_code="de-DE"), mod.TTSClient(stub.url)
        res = (asr.transcribe(b"\x01\x02", "clip.ogg"), list(asr.streaming_recognize([b"a", b"b"])),
               tts.synthesize("hallo", response_format="wav"))
        sent = [(m, p, b if ct != "application/json" else json.loads(b))
                for m, p, ct, b in stub.got]
        out.append((res, sent))
    assert out[1] == out[0]
