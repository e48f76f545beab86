"""The port's Triton-protocol client (generativeaiexamples_tpu_torch/
experimental/azureml/) against the JAX repository's experimental/azureml/
on the CPU:

- the three tests of tests/test_experimental_azureml.py on the port;
- one recording stub server that both clients hit: the same paths,
  bodies (the eight KServe-v2 input tensors with their names, datatypes
  and [1, 1] shapes) and headers (the bearer token and extra headers),
  the same parsed replies, the same ``RuntimeError`` on a reply with no
  ``text_output`` and the same ``HTTPError`` on a 500; readiness on 200,
  503 and a closed port;
- the slice: ``TritonLLMBackend`` of each package drives one CVE through
  each package's ``CVEPipeline`` against the stub: the same requests in
  the same order and the same verdict;
- the new modules import no JAX, no JAX package, no root ``experimental``
  or ``tools``, no aiohttp or requests.
"""
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from experimental.azureml import TritonHTTPClient as JClient
from experimental.azureml import TritonLLMBackend as JBackend
from experimental.cve_analysis.pipeline import CVEPipeline as JPipeline
from generativeaiexamples_tpu_torch.experimental.azureml import TritonHTTPClient, TritonLLMBackend
from generativeaiexamples_tpu_torch.experimental.cve_analysis.pipeline import CVEPipeline

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "generativeaiexamples_tpu", "experimental", "tools", "aiohttp", "requests")
NEW_MODULES = [
    "generativeaiexamples_tpu_torch.experimental.azureml",
    "generativeaiexamples_tpu_torch.experimental.azureml.triton_client",
]
INPUTS = [("text_input", "BYTES"), ("max_tokens", "INT32"), ("temperature", "FP32"),
          ("runtime_top_k", "INT32"), ("runtime_top_p", "FP32"), ("beam_width", "INT32"),
          ("repetition_penalty", "FP32"), ("len_penalty", "FP32")]


class _FakeTriton(BaseHTTPRequestHandler):
    """tests/test_experimental_azureml.py's fake server."""

    last_request = None
    auth_header = None

    def do_GET(self):
        self.send_response(200 if self.path == "/v2/health/ready" else 404)
        self.end_headers()

    def do_POST(self):
        type(self).auth_header = self.headers.get("Authorization")
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).last_request = {"path": self.path, "body": body}
        inputs = {t["name"]: t["data"][0] for t in body["inputs"]}
        answer = f"echo:{inputs['text_input']}|max:{inputs['max_tokens']}"
        resp = json.dumps({"outputs": [{"name": "text_output", "shape": [1, 1],
                                        "datatype": "BYTES", "data": [answer]}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *args):
        pass


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, name="test-triton-stub", daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)

    return f"http://127.0.0.1:{server.server_port}", stop


@pytest.fixture()
def triton_server():
    base, stop = _serve(_FakeTriton)
    yield base
    stop()


# --------------------------------------------------------------------------- #
# tests/test_experimental_azureml.py on the port


def test_client_infer_roundtrip(triton_server):
    client = TritonHTTPClient(triton_server, api_key="sekret")
    assert client.server_ready()
    assert client.infer("ensemble", "hello triton", tokens=42, temperature=0.5) == \
        "echo:hello triton|max:42"
    assert _FakeTriton.auth_header == "Bearer sekret"
    assert _FakeTriton.last_request["path"] == "/v2/models/ensemble/infer"
    names = [t["name"] for t in _FakeTriton.last_request["body"]["inputs"]]
    for expected, _ in INPUTS:
        assert expected in names


def test_backend_stream_chat_with_stop(triton_server):
    backend = TritonLLMBackend(triton_server, model_name="trt")
    assert list(backend.stream_chat([("user", "hi")], max_tokens=7, stop=("|",))) == \
        ["echo:user: hi"]


def test_server_ready_false_when_down():
    assert not TritonHTTPClient("http://127.0.0.1:1", timeout=0.5).server_ready()


# --------------------------------------------------------------------------- #
# both clients against one recording stub


class _Recorder(BaseHTTPRequestHandler):
    """Records every request (method, path, headers it was sent, body) and
    answers by the path: ``/v2/models/<mode>/infer`` picks the reply."""

    records = []
    ready_status = 200
    protocol_version = "HTTP/1.1"

    def _record(self, body):
        headers = {k.lower(): v for k, v in self.headers.items()
                   if k.lower() not in ("host", "connection", "accept-encoding")}
        type(self).records.append((self.command, self.path, headers, body))

    def _send(self, status, payload, ctype="application/json"):
        data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._record(None)
        if self.path == "/v2/health/ready":
            self._send(type(self).ready_status, b"", "text/plain")
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self._record(body)
        mode = self.path.split("/")[3]
        inputs = {t["name"]: t["data"][0] for t in body["inputs"]}
        if mode == "broken":
            self._send(500, b"internal error", "text/plain")
        elif mode == "no_output":
            self._send(200, {"model_name": mode, "outputs": [{"name": "other", "data": ["x"]}]})
        elif mode == "empty":
            self._send(200, {"outputs": [{"name": "text_output", "data": []}]})
        elif mode == "number":
            self._send(200, {"outputs": [{"name": "text_output", "data": [7]}]})
        else:
            text = inputs["text_input"]
            reply = ('["Check the lxml version"]' if "containerized environment" in text else
                     '{"final": "ok STOP tail"}' if "Tools:" in text else
                     '{"exploitable": false, "summary": "n/a"} STOP x')
            self._send(200, {"outputs": [{"name": "text_output", "shape": [1, 1],
                                          "datatype": "BYTES", "data": [reply]}]})

    def log_message(self, *args):
        pass


@pytest.fixture()
def recorder():
    _Recorder.records = []
    _Recorder.ready_status = 200
    base, stop = _serve(_Recorder)
    yield base
    stop()


def _pair(base, **kw):
    return TritonHTTPClient(base, **kw), JClient(base, **kw)


def _take():
    out = list(_Recorder.records)
    _Recorder.records.clear()
    return out


CLIENT_KW = [
    {},
    {"api_key": "sekret"},
    {"api_key": "k", "extra_headers": {"azureml-model-deployment": "blue", "X-Trace": "1"}},
    {"extra_headers": {"Authorization": "Bearer from-extra"}, "api_key": "overridden"},
]


@pytest.mark.parametrize("kw", CLIENT_KW, ids=["plain", "bearer", "extra", "extra_wins"])
@pytest.mark.parametrize("args", [
    dict(prompt="hello triton", tokens=42, temperature=0.5),
    dict(prompt="ünïcode ✓ \"quotes\"\nnew line", tokens=1, temperature=0.0, top_k=5, top_p=0.9,
         beam_width=2, repetition_penalty=1.2, length_penalty=0.8),
    dict(prompt="", tokens=3.7, temperature=1),
])
def test_infer_sends_jax_s_requests_and_parses_jax_s_replies(recorder, kw, args):
    port, ref = _pair(recorder, **kw)
    got = port.infer("ensemble", **args)
    port_records = _take()
    want = ref.infer("ensemble", **args)
    assert got == want
    assert port_records == _take()
    method, path, headers, body = port_records[0]
    assert (method, path) == ("POST", "/v2/models/ensemble/infer")
    assert headers["content-type"] == "application/json"
    assert [(t["name"], t["datatype"], t["shape"]) for t in body["inputs"]] == \
        [(n, d, [1, 1]) for n, d in INPUTS]
    assert body["outputs"] == [{"name": "text_output"}]
    if kw.get("api_key") and "extra_headers" not in kw:
        assert headers["authorization"] == f"Bearer {kw['api_key']}"
    for key, value in (kw.get("extra_headers") or {}).items():
        assert headers[key.lower()] == value


@pytest.mark.parametrize("mode,expected", [("empty", ""), ("number", "7")])
def test_reply_edge_cases_equal_jax(recorder, mode, expected):
    port, ref = _pair(recorder)
    assert port.infer(mode, "p") == ref.infer(mode, "p") == expected


def test_missing_text_output_raises_jax_s_error(recorder):
    port, ref = _pair(recorder)
    with pytest.raises(RuntimeError) as got:
        port.infer("no_output", "p")
    with pytest.raises(RuntimeError) as want:
        ref.infer("no_output", "p")
    assert str(got.value) == str(want.value) == \
        "No text_output tensor in response: ['model_name', 'outputs']"


def test_http_500_raises_jax_s_error(recorder):
    port, ref = _pair(recorder, api_key="k")
    with pytest.raises(urllib.error.HTTPError) as got:
        port.infer("broken", "p")
    with pytest.raises(urllib.error.HTTPError) as want:
        ref.infer("broken", "p")
    assert (got.value.code, got.value.url, got.value.read()) == \
        (want.value.code, want.value.url, want.value.read()) == \
        (500, f"{recorder}/v2/models/broken/infer", b"internal error")


@pytest.mark.parametrize("status,ready", [(200, True), (503, False)])
def test_server_ready_equals_jax(recorder, status, ready):
    _Recorder.ready_status = status
    port, ref = _pair(recorder, api_key="k", extra_headers={"X-A": "b"})
    assert port.server_ready() is ref.server_ready() is ready
    records = _take()
    assert records[0] == records[1]
    assert records[0][:2] == ("GET", "/v2/health/ready")
    assert records[0][2]["authorization"] == "Bearer k" and records[0][2]["x-a"] == "b"


def test_trailing_slash_and_timeout_equal_jax(recorder):
    port, ref = _pair(recorder + "///", timeout=7.5)
    assert (port.server_url, port.timeout, port.headers) == (ref.server_url, ref.timeout, ref.headers)
    assert port.infer("m", "x") == ref.infer("m", "x")


@pytest.mark.parametrize("messages,stop", [
    ([("user", "hi")], ()),
    ([("system", "be brief"), ("user", "Tools: please")], ("STOP",)),
    ([("user", "a")], ("", "nothere", "}")),
    ([("assistant", "x"), ("user", "y")], ("STOP", "ok")),
])
def test_backend_prompt_stop_and_chunk_equal_jax(recorder, messages, stop):
    port = TritonLLMBackend(recorder, model_name="ensemble", api_key="k")
    ref = JBackend(recorder, model_name="ensemble", api_key="k")
    kwargs = dict(temperature=0.3, top_p=0.4, max_tokens=9, stop=stop, prefix_hint="chain",
                  spec_decode=False)
    got = list(port.stream_chat(messages, **kwargs))
    port_records = _take()
    assert got == list(ref.stream_chat(messages, **kwargs))
    assert port_records == _take()
    assert len(got) == 1
    assert port.complete(messages, **kwargs) == got[0]
    body = port_records[0][3]
    text = {t["name"]: t["data"][0] for t in body["inputs"]}
    assert text["text_input"] == "\n".join(f"{r}: {c}" for r, c in messages)
    assert (text["max_tokens"], text["temperature"], text["runtime_top_p"]) == (9, 0.3, 0.4)


def test_cve_pipeline_over_triton_equals_jax(recorder):
    """The slice: one CVE through each package's pipeline, each on its own
    package's Triton backend."""
    cve = "CVE-2022-2309: lxml through 4.9.1"
    port = CVEPipeline(TritonLLMBackend(recorder, api_key="k")).run_sync([cve])
    port_records = _take()
    ref = JPipeline(JBackend(recorder, api_key="k")).run_sync([cve])
    assert [v.as_dict() for v in port] == [v.as_dict() for v in ref]
    assert port_records == _take()
    assert len(port_records) == 3  # checklist, one item, verdict
    assert port[0].checklist == ["Check the lxml version"]
    assert port[0].traces[0].finding == "ok STOP tail"
    assert port[0].summary == "n/a"


def test_new_modules_import_no_jax_and_no_root_packages():
    code = ("import importlib, json, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(NEW_MODULES) <= set(loaded)
    assert [m for m in loaded if m.split(".")[0] in FORBIDDEN] == []
