"""The port's chain server (generativeaiexamples_tpu_torch/server/) against
the JAX package's, side by side on the CPU: the JAX server through its
aiohttp app, the port's over HTTP, the same requests to both.

- Every scenario of tests/test_server_api.py (health, the golden stream,
  validation 422, a chain error, a vector-store error, the documents round
  trip, RAG over ingested context) and the resilience surface (429 from
  ``max_active_streams`` and from ``EngineOverloaded``, 504 from a spent
  deadline, a deadline and a timeout mid-stream, the degraded warnings
  frame): equal status codes and JSON bodies, and SSE bytes identical once
  each frame's uuid ``id`` is masked.
- The sanitizer against ``bleach.clean(v, strip=True)`` and the request
  validation against the JAX package's pydantic schemas, on generated
  input (hypothesis).
- One ``developer_rag`` answer streamed from the port's debug-preset
  engine on the CPU, and a client that disconnects mid-stream aborting
  its engine request.
- The text chains (``simple_rag``, ``api_catalog``, ``multi_turn``,
  ``query_decomposition``, picked by ``EXAMPLE_NAME`` through each
  package's registry) over hash embeddings and the echo LLM: uploads,
  listings, ``/search``, ``/generate`` with and without the knowledge base
  and ``DELETE``, with equal bodies and SSE bytes from both servers.
"""
import asyncio
import http.client
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import bleach
import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from pydantic import ValidationError as PydanticValidationError

from generativeaiexamples_tpu.chains import runtime as jruntime
from generativeaiexamples_tpu.chains.echo import EchoChain as JEcho
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.retrieval.errors import VectorStoreError as JVectorStoreError
from generativeaiexamples_tpu.server import api as japi
from generativeaiexamples_tpu.server import schemas as jschemas
from generativeaiexamples_tpu.utils import resilience as jres
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import runtime as truntime
from generativeaiexamples_tpu_torch.chains.echo import EchoChain as TEcho
from generativeaiexamples_tpu_torch.engine import llm_engine
from generativeaiexamples_tpu_torch.engine.llm_engine import EngineOverloaded as TOverloaded
from generativeaiexamples_tpu_torch.retrieval.errors import VectorStoreError as TVectorStoreError
from generativeaiexamples_tpu_torch.server import schemas as tschemas
from generativeaiexamples_tpu_torch.server.api import make_server
from generativeaiexamples_tpu_torch.server.sanitize import clean
from generativeaiexamples_tpu_torch.utils import resilience as tres

_UUID = re.compile(rb'"id":"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}"')

# the two packages' versions of what a scenario's chain needs
JAX = {"echo": JEcho, "vse": JVectorStoreError, "overloaded": jres.EngineOverloaded,
       "deadline": jres.DeadlineExceeded, "res": jres, "degraded": jruntime.DegradedWarning}
PORT = {"echo": TEcho, "vse": TVectorStoreError, "overloaded": TOverloaded,
        "deadline": tres.DeadlineExceeded, "res": tres, "degraded": truntime.DegradedWarning}


@pytest.fixture
def app_env(monkeypatch, tmp_path):
    """A clean APP_* environment (no engine, hash embeddings) read afresh
    by both packages; uploads under tmp_path."""
    for key in list(os.environ):
        if key.startswith("APP_") or key in ("EXAMPLE_NAME", "DOC_UPLOAD_DIR"):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_LLM_MODELENGINE", "echo")
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("DOC_UPLOAD_DIR", str(tmp_path / "uploads"))
    monkeypatch.setattr(japi, "UPLOAD_FOLDER", str(tmp_path / "uploads"))
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()
    yield monkeypatch
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


def _mask(body: bytes) -> bytes:
    return _UUID.sub(b'"id":"<uuid>"', body)


class _Req:
    def __init__(self, method, path, body=None, raw=None, headers=None):
        self.method, self.path, self.headers = method, path, dict(headers or {})
        if body is not None:
            raw = json.dumps(body).encode()
            self.headers.setdefault("Content-Type", "application/json")
        self.raw = raw


def _run_jax(example_cls, requests, concurrent=None):
    async def run():
        app = japi.create_app(example_cls)
        async with TestClient(TestServer(app)) as client:
            async def one(r):
                resp = await client.request(r.method, r.path, data=r.raw, headers=r.headers)
                return resp.status, dict(resp.headers), await resp.read()

            out = []
            for r in requests:
                if concurrent is not None and r is concurrent[0]:
                    first = asyncio.ensure_future(one(r))
                    await asyncio.get_running_loop().run_in_executor(None, concurrent[1].wait, 30)
                    continue
                out.append(await one(r))
            if concurrent is not None:
                concurrent[2].set()
                out.insert(0, await first)
            return out

    return asyncio.run(run())


def _port_request(base, r):
    req = urllib.request.Request(base + r.path, data=r.raw, method=r.method, headers=r.headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def _run_port(example_cls, requests, concurrent=None):
    server = make_server("127.0.0.1", 0, example_cls)
    thread = threading.Thread(target=server.serve_forever, name="test-chain-server", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        out, first = [], {}
        for r in requests:
            if concurrent is not None and r is concurrent[0]:
                th = threading.Thread(target=lambda r=r: first.update(v=_port_request(base, r)),
                                      name="test-first-request", daemon=True)
                th.start()
                assert concurrent[1].wait(30)
                continue
            out.append(_port_request(base, r))
        if concurrent is not None:
            concurrent[2].set()
            th.join(60)
            assert not th.is_alive()
            out.insert(0, first["v"])
        return out
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)


def _assert_same(jax_out, port_out):
    assert len(jax_out) == len(port_out)
    for (js, jh, jb), (ps, ph, pb) in zip(jax_out, port_out):
        assert ps == js, (jb, pb)
        jtype, ptype = jh.get("Content-Type", ""), ph.get("Content-Type", "")
        assert ptype == jtype
        if jtype.startswith("application/json"):
            assert json.loads(pb) == json.loads(jb)
        else:
            assert _mask(pb) == _mask(jb)
        for name in ("Retry-After", "X-GenAI-Queue-Depth", "Access-Control-Allow-Origin"):
            assert ph.get(name) == jh.get(name), name


def _both(make_chain, requests_fn, concurrent=False):
    """Run the scenario against both servers: ``make_chain(pkg)`` builds
    each package's chain class (``pkg`` is JAX or PORT), ``requests_fn()``
    the request list."""
    outs = []
    for run, pkg in ((_run_jax, JAX), (_run_port, PORT)):
        reqs = requests_fn()
        events = (threading.Event(), threading.Event()) if concurrent else None
        cls = make_chain(pkg, events)
        outs.append(run(cls, reqs, (reqs[0],) + events if concurrent else None))
    _assert_same(*outs)
    return outs[1]


def _fresh_echo(pkg, documents=None):
    return type("FreshEcho", (pkg["echo"],), {"documents": dict(documents or {})})


def _gen(content, kb=False, **extra):
    return _Req("POST", "/generate", {"messages": [{"role": "user", "content": content}],
                                      "use_knowledge_base": kb, **extra})


def _frames(body: bytes):
    out = []
    for block in body.decode().split("\n\n"):
        if block.strip():
            assert block.startswith("data: "), block
            out.append(json.loads(block[6:]))
    return out


# --------------------------------------------------------------------------- #
# the scenarios of tests/test_server_api.py, on both servers


def test_health_and_readiness(app_env):
    out = _both(lambda pkg, ev: pkg["echo"],
                lambda: [_Req("GET", "/health"), _Req("GET", "/internal/ready"),
                         _Req("OPTIONS", "/generate"), _Req("GET", "/no/such/route")])
    assert json.loads(out[0][2]) == {"message": "Service is up."}
    assert json.loads(out[1][2]) == {"ready": True, "wedged": False}
    assert [o[0] for o in out[2:]] == [204, 404]


@pytest.mark.parametrize("content", [
    "hello tpu world",
    "a & b <b>bold</b> <script>x()</script> ü \"q\" 'x' <",
    "line one\nline two\ttab \x01 control",
    "",
])
def test_generate_stream_golden(app_env, content):
    out = _both(lambda pkg, ev: pkg["echo"], lambda: [_gen(content)])
    frames = _frames(out[0][2])
    assert out[0][1]["Content-Type"] == "text/event-stream"
    assert frames[-1]["choices"][0]["finish_reason"] == "[DONE]"
    assert len(frames) == len(clean(content).split(" ")) + 1


_BAD_BODIES = [
    {"messages": [{"role": "wizard", "content": "x"}], "use_knowledge_base": False},
    {"messages": [{"role": "user", "content": "x"}]},
    {"messages": [{"role": "user"}], "use_knowledge_base": "maybe", "temperature": 0.05,
     "top_p": "abc", "max_tokens": 5.5, "stop": "x", "deadline_ms": -1},
    {"messages": [1, {"role": 5}, {"role": "r" * 300}], "use_knowledge_base": None,
     "max_tokens": 2000, "stop": ["a"] * 257},
    {"messages": "x", "use_knowledge_base": [], "top_p": 2, "max_tokens": "7x"},
    [1, 2],
]


@pytest.mark.parametrize("body", _BAD_BODIES)
def test_generate_validation_422(app_env, body):
    out = _both(lambda pkg, ev: pkg["echo"], lambda: [_Req("POST", "/generate", body)])
    assert out[0][0] == 422 and json.loads(out[0][2])["detail"][0]["loc"][0] == "body"


@pytest.mark.parametrize("raw", [b"{not json", b""])
def test_invalid_json_422(app_env, raw):
    out = _both(lambda pkg, ev: pkg["echo"], lambda: [
        _Req("POST", "/generate", raw=raw, headers={"Content-Type": "application/json"}),
        _Req("POST", "/search", raw=raw, headers={"Content-Type": "application/json"}),
        _Req("POST", "/search", {"query": 3, "top_k": 26})])
    assert [o[0] for o in out] == [422, 422, 422]


def test_chain_error_is_a_500_stream(app_env):
    def make(pkg, ev):
        def llm_chain(self, query, chat_history, **kwargs):
            raise RuntimeError("boom")

        return type("Boom", (pkg["echo"],), {"llm_chain": llm_chain})

    out = _both(make, lambda: [_gen("x")])
    assert out[0][0] == 500 and "chain server" in _frames(out[0][2])[0]["choices"][0]["message"]["content"]


def test_vector_store_error_is_a_500_stream(app_env):
    def make(pkg, ev):
        def rag_chain(self, query, chat_history, **kwargs):
            raise pkg["vse"]("vector db down")

        return type("Down", (pkg["echo"],), {"rag_chain": rag_chain})

    out = _both(make, lambda: [_gen("x", kb=True)])
    assert out[0][0] == 500 and "milvus" in out[0][2].decode()


def test_documents_round_trip(app_env):
    boundary = "b0undary"
    raw = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
           f"filename=\"../doc1.txt\"\r\nContent-Type: text/plain\r\n\r\nalpha beta gamma\r\n"
           f"--{boundary}--\r\n").encode()
    upload = {"Content-Type": f"multipart/form-data; boundary={boundary}"}
    empty = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"other\"\r\n\r\nx\r\n"
             f"--{boundary}--\r\n").encode()
    out = _both(lambda pkg, ev: _fresh_echo(pkg), lambda: [
        _Req("POST", "/documents", raw=raw, headers=upload),
        _Req("POST", "/documents", raw=empty, headers=upload),
        _Req("GET", "/documents"),
        _Req("POST", "/search", {"query": "alpha", "top_k": 4}),
        _Req("DELETE", "/documents?filename=doc1.txt"),
        _Req("GET", "/documents"),
        _Req("DELETE", "/documents"),
    ])
    assert json.loads(out[0][2]) == {"message": "File uploaded successfully"}
    assert json.loads(out[1][2]) == {"message": "No files provided"}
    assert json.loads(out[2][2]) == {"documents": ["doc1.txt"]}  # the base name only
    assert json.loads(out[3][2])["chunks"][0] == {"content": "alpha beta gamma", "filename": "doc1.txt",
                                                 "score": 1.0}
    assert json.loads(out[5][2]) == {"documents": []}


def test_generate_rag_uses_ingested_context(app_env):
    out = _both(lambda pkg, ev: _fresh_echo(pkg, {"d": "0123456789"}), lambda: [_gen("q", kb=True)])
    assert _frames(out[0][2])[0]["choices"][0]["message"]["content"] == "context:10 "


# --------------------------------------------------------------------------- #
# the text chains


def _upload_req(name, data: bytes):
    boundary = "chain-boundary"
    raw = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"{name}\""
           f"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return _Req("POST", "/documents", raw=raw,
                headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})


_CHAIN_DOC = (b"The paged pool holds kv pages for every decode slot. Each page stores 128 rows "
              b"of keys and values. A page table maps a slot to its pages. The allocator frees "
              b"pages when a request ends.")


@pytest.mark.parametrize("example", ["simple_rag", "nvidia_api_catalog", "multi_turn_rag",
                                     "query_decomposition"])
def test_text_chains_answer_alike_through_both_servers(app_env, tmp_path, example):
    app_env.setenv("EXAMPLE_NAME", example)
    query = "what does a page table map?"
    history = {"messages": [{"role": "user", "content": "what does the paged pool hold?"},
                            {"role": "assistant", "content": "kv pages"},
                            {"role": "user", "content": query}],
               "use_knowledge_base": True, "max_tokens": 48}

    def requests():
        return [
            _upload_req("pool.txt", _CHAIN_DOC),
            _upload_req("empty.md", b"# Heading only"),
            _upload_req("table.csv", b"a,b\n1,2\n"),  # multi_turn refuses the suffix
            _Req("GET", "/documents"),
            _Req("POST", "/search", {"query": "page table slot", "top_k": 4}),
            _gen(query, kb=True, max_tokens=48),
            _Req("POST", "/generate", history),
            _gen(query, kb=False, max_tokens=8),
            _Req("DELETE", "/documents?filename=pool.txt"),
            _Req("GET", "/documents"),
            _gen(query, kb=True, max_tokens=48),
        ]

    outs = []
    for run, pkg in ((_run_jax, "jax"), (_run_port, "port")):
        # each package's runtime reads its own store directory
        app_env.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / pkg))
        jget_config.cache_clear()
        tconfig.get_config.cache_clear()
        jruntime.reset_runtime()
        truntime.reset_runtime()
        truntime.set_device("cpu")
        try:
            outs.append(run(None, requests()))
        finally:
            jruntime.reset_runtime()
            truntime.reset_runtime()
            truntime.set_device(None)
    _assert_same(*outs)
    out = outs[1]
    assert [o[0] for o in out[:2] + out[3:5]] == [200, 200, 200, 200]
    if example == "multi_turn_rag":
        assert out[2][0] == 500 and json.loads(out[2][2]) == {
            "message": "table.csv is not a valid Text, PDF or Markdown file"}
    assert json.loads(out[4][2])["chunks"][0]["filename"] == "pool.txt"
    for o in (out[5], out[6], out[7]):
        frames = _frames(o[2])
        assert o[0] == 200 and frames[-1]["choices"][0]["finish_reason"] == "[DONE]"
        answer = "".join(f["choices"][0]["message"]["content"] for f in frames[:-1])
        assert answer and "No response generated" not in answer
    assert "pool.txt" not in json.loads(out[9][2])["documents"]


@pytest.mark.parametrize("example,status", [("simple_rag", 500), ("api_catalog", 200)])
def test_a_failed_retrieval_surfaces_as_in_jax(app_env, tmp_path, monkeypatch, example, status):
    """simple_rag's document_search lets a retrieval error through (a 500
    from /search) and its /generate degrades; api_catalog answers [] and
    its canned message."""
    from generativeaiexamples_tpu.chains.registry import resolve_example as jresolve
    from generativeaiexamples_tpu_torch.chains.registry import resolve_example as tresolve

    def boom(*args, **kwargs):
        raise RuntimeError("store down")

    app_env.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path))
    for rt in (jruntime, truntime):
        monkeypatch.setattr(rt, "retrieve", boom)
    out = _both(lambda pkg, ev: (jresolve if pkg is JAX else tresolve)(example),
                lambda: [_Req("POST", "/search", {"query": "q", "top_k": 2}), _gen("q", kb=True)])
    assert out[0][0] == status and out[1][0] == 200
    frames = _frames(out[1][2])
    if example == "simple_rag":
        assert frames[0]["warnings"] == [
            "retrieval_degraded: RuntimeError: store down; answering without retrieved context"]
    else:
        assert json.loads(out[0][2]) == {"chunks": []}


# --------------------------------------------------------------------------- #
# admission, deadlines, degradation


def test_429_past_max_active_streams(app_env):
    app_env.setenv("APP_RESILIENCE_MAXACTIVESTREAMS", "1")
    app_env.setenv("APP_RESILIENCE_SHEDRETRYAFTERS", "2.5")

    def make(pkg, ev):
        started, release = ev

        def llm_chain(self, query, chat_history, **kwargs):
            started.set()
            release.wait(30)
            return iter(["held "])

        return type("Held", (pkg["echo"],), {"llm_chain": llm_chain})

    out = _both(make, lambda: [_gen("first"), _gen("second")], concurrent=True)
    assert out[0][0] == 200 and out[1][0] == 429
    assert out[1][1]["Retry-After"] == "2" and "X-GenAI-Queue-Depth" not in out[1][1]
    assert json.loads(out[1][2]) == {"detail": "server overloaded (active_streams); retry later"}


def test_429_from_engine_overloaded(app_env):
    def make(pkg, ev):
        def llm_chain(self, query, chat_history, **kwargs):
            raise pkg["overloaded"]("engine admission queue full (8/8 pending)")

        return type("Full", (pkg["echo"],), {"llm_chain": llm_chain})

    out = _both(make, lambda: [_gen("x")])
    assert out[0][0] == 429 and out[0][1]["Retry-After"] == "1"
    assert json.loads(out[0][2]) == {"detail": "engine admission queue full (8/8 pending)"}


def test_429_while_the_live_engine_queue_is_full(app_env, monkeypatch):
    """engine_queue_cap reads the live engine's queue (never builds one)."""
    from generativeaiexamples_tpu.engine import llm_engine as jllm_engine

    class Queue:
        def queue_depth(self):
            return 3

    app_env.setenv("APP_RESILIENCE_ENGINEQUEUECAP", "3")
    monkeypatch.setattr(jllm_engine, "_ENGINE", Queue())
    monkeypatch.setattr(llm_engine, "_ENGINE", Queue())
    out = _both(lambda pkg, ev: pkg["echo"], lambda: [_gen("x")])
    assert out[0][0] == 429 and out[0][1]["X-GenAI-Queue-Depth"] == "3"


def test_504_for_a_deadline_spent_before_the_stream(app_env):
    def make(pkg, ev):
        def rag_chain(self, query, chat_history, **kwargs):
            time.sleep(0.2)
            pkg["res"].raise_if_deadline_expired("retrieval")
            return iter(["in time "])

        return type("Slow", (pkg["echo"],), {"rag_chain": rag_chain})

    out = _both(make, lambda: [
        _gen("x", kb=True, deadline_ms=100),
        _Req("POST", "/generate", {"messages": [{"role": "user", "content": "x"}],
                                   "use_knowledge_base": True, "deadline_ms": 0},
             headers={"X-Request-Deadline-Ms": "100"}),
        _gen("x", kb=True, deadline_ms=0)])
    assert [o[0] for o in out] == [504, 504, 200]
    assert json.loads(out[0][2]) == {
        "detail": "request deadline exhausted before retrieval (budget 0.100s)"}


def test_deadline_and_timeout_mid_stream_end_with_a_warning(app_env):
    def make(pkg, ev):
        def llm_chain(self, query, chat_history, **kwargs):
            yield "partial "
            if query == "deadline":
                raise pkg["deadline"]("request deadline exhausted mid-stream")
            raise TimeoutError("LLM engine timed out")

        return type("Cut", (pkg["echo"],), {"llm_chain": llm_chain})

    out = _both(make, lambda: [_gen("deadline"), _gen("timeout")])
    for o in out:
        frames = _frames(o[2])
        assert o[0] == 200 and frames[-1]["choices"][0]["finish_reason"] == "[DONE]"
        assert frames[-1]["warnings"][0].startswith("deadline_exceeded: ")


def test_degraded_warning_frame_and_empty_chain(app_env):
    def make(pkg, ev):
        def rag_chain(self, query, chat_history, **kwargs):
            yield pkg["degraded"](reason="retrieval_degraded", detail="RuntimeError: down")
            yield "llm only "

        def llm_chain(self, query, chat_history, **kwargs):
            return None

        return type("Degraded", (pkg["echo"],), {"rag_chain": rag_chain, "llm_chain": llm_chain})

    out = _both(make, lambda: [_gen("x", kb=True), _gen("x")])
    frames = _frames(out[0][2])
    assert frames[0] == {"id": frames[0]["id"], "choices": [],
                         "warnings": ["retrieval_degraded: RuntimeError: down"]}
    assert out[1][2] == b'data: {"id":"","choices":[]}\n\n'


def test_drain_and_snapshot_routes_answer_501(app_env):
    server = make_server("127.0.0.1", 0, TEcho)
    thread = threading.Thread(target=server.serve_forever, name="test-501", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        for method, path in [("POST", "/internal/drain"), ("GET", "/internal/snapshots"),
                             ("GET", "/internal/snapshots/abc"), ("POST", "/internal/restore")]:
            status, _, body = _port_request(base, _Req(method, path, {}))
            assert status == 501 and "ROADMAP queue 1 item 8" in json.loads(body)["detail"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)


# --------------------------------------------------------------------------- #
# the sanitizer and the validation, on generated input

_MARKUP = st.sampled_from([
    "<b>", "</b>", "<i>", "</i>", "<a href='http://x'>", "<a href=\"javascript:y\" title=t>",
    "</a>", "<li>", "</li>", "<ul>", "</ul>", "<ol>", "<blockquote>", "</blockquote>",
    "<abbr title=\"q&amp;\">", "<em>", "<strong>", "<code>", "<p>", "</p>", "<div>", "<br/>",
    "<script>", "</script>", "<!-- c -->", "<!x>", "<?p ?>", "&", "&amp;", "&lt", "&#39;", "&am;",
    "&#x41;", "<", ">", "</", "</3>", "<b", "< b", "<B title='T'>", "\x00", "\x01", "\x0c", "\r\n",
])
_TEXT = st.one_of(_MARKUP, st.text(alphabet=st.characters(codec="utf-8"), max_size=6))


@settings(max_examples=600, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_TEXT, max_size=14).map("".join))
def test_sanitizer_equals_bleach(text):
    assert clean(text) == bleach.clean(text, strip=True)


# floats as integer ratios and a sampled set (hypothesis's float strategy
# refuses to run where another library turned on flush-to-zero)
_FLOATS = st.one_of(st.integers(-30000, 30000).map(lambda i: i / 1000),
                    st.sampled_from([0.1, 1.0, 0.5, -0.0, 2.0, 1e19, 9.2e18, 3.4e38, 1e-7]))
_JSONISH = st.recursive(
    st.one_of(st.none(), st.booleans(), st.integers(-3000, 3000), _FLOATS,
              st.sampled_from(["", "user", "USER", "system", "assistant", "0.5", "7", "yes", "off",
                               "1_0", " 5 ", "5.0", "x<b>y</b>", "abc"])),
    lambda children: st.lists(children, max_size=3), max_leaves=6)
_MESSAGE = st.fixed_dictionaries({}, optional={"role": _JSONISH, "content": _JSONISH})
_PROMPT = st.fixed_dictionaries({}, optional={
    "messages": st.one_of(st.lists(st.one_of(_MESSAGE, _JSONISH), max_size=3), _JSONISH),
    "use_knowledge_base": _JSONISH, "temperature": _JSONISH, "top_p": _JSONISH,
    "max_tokens": _JSONISH, "stop": _JSONISH, "deadline_ms": _JSONISH, "extra": _JSONISH})


def _jax_validate(cls, body):
    try:
        return "ok", cls.model_validate(body).model_dump()
    except PydanticValidationError as exc:
        return "error", json.loads(japi._validation_error_response(exc).text)


def _port_validate(cls, body):
    try:
        obj = cls.validate(body)
    except tschemas.ValidationError as exc:
        return "error", tschemas.validation_error_body(exc)
    out = {k: getattr(obj, k) for k in obj.__dataclass_fields__}
    if "messages" in out:
        out["messages"] = [m.to_dict() for m in out["messages"]]
    return "ok", out


@settings(max_examples=400, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(_PROMPT)
def test_prompt_validation_equals_pydantic(body):
    assert _port_validate(tschemas.Prompt, body) == _jax_validate(jschemas.Prompt, body)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.fixed_dictionaries({}, optional={"query": _JSONISH, "top_k": _JSONISH}))
def test_search_validation_equals_pydantic(body):
    assert _port_validate(tschemas.DocumentSearch, body) == _jax_validate(jschemas.DocumentSearch, body)


# --------------------------------------------------------------------------- #
# developer_rag on the port's CPU engine


@pytest.fixture
def rag_server(app_env, tmp_path):
    for key, value in {
        "APP_LLM_MODELENGINE": "tpu", "APP_ENGINE_MODELCONFIGNAME": "debug",
        "APP_ENGINE_MAXBATCHSIZE": "2", "APP_ENGINE_MAXSEQLEN": "128",
        "APP_ENGINE_PREFILLCHUNK": "16", "APP_ENGINE_PAGESIZE": "8",
        "APP_RANKING_MODELENGINE": "overlap", "APP_RETRIEVER_SCORETHRESHOLD": "0",
        "APP_VECTORSTORE_PERSISTDIR": str(tmp_path / "store"), "EXAMPLE_NAME": "developer_rag",
    }.items():
        app_env.setenv(key, value)
    tconfig.get_config.cache_clear()
    truntime.reset_runtime()
    truntime.set_device("cpu")
    server = make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="test-rag-server", daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", server
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        engine = llm_engine._ENGINE
        if engine is not None:
            assert engine.shutdown()
        with llm_engine._ENGINE_LOCK:
            llm_engine._ENGINE = None
        truntime.reset_runtime()
        truntime.set_device(None)


def _upload(base, name, data):
    boundary = "rag-boundary"
    raw = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; filename=\"{name}\"\r\n"
           f"\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return _port_request(base, _Req("POST", "/documents", raw=raw, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"}))


def test_developer_rag_streams_an_answer_from_the_cpu_engine(rag_server):
    base, server = rag_server
    assert _upload(base, "gpu.txt", b"the paged pool holds kv pages for every slot")[0] == 200
    assert _upload(base, "tpu.md", b"# mesh\n\nthe mesh shards weights over chips")[0] == 200
    status, _, body = _port_request(base, _Req("POST", "/search", {"query": "kv pages", "top_k": 2}))
    assert status == 200 and json.loads(body)["chunks"][0]["filename"] == "gpu.txt"
    status, headers, body = _port_request(base, _gen("what holds kv pages?", kb=True, max_tokens=16))
    frames = _frames(body)
    assert status == 200 and headers["Content-Type"] == "text/event-stream"
    assert frames[-1]["choices"][0]["finish_reason"] == "[DONE]"
    assert all(f["id"] == frames[0]["id"] for f in frames)
    answer = "".join(f["choices"][0]["message"]["content"] for f in frames)
    assert "No response generated" not in answer and "Error from" not in answer
    engine = llm_engine._ENGINE
    assert engine is not None and engine.device.type == "cpu"
    assert engine.stats()["prefill_waves"] >= 1


def test_a_client_that_disconnects_aborts_its_engine_request(rag_server):
    base, server = rag_server
    host, port = server.server_address
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("POST", "/generate", json.dumps({
        "messages": [{"role": "user", "content": "go on"}], "use_knowledge_base": False,
        "max_tokens": 1024, "temperature": 1.0}), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    resp.fp.readline()  # the first frame is out: the request holds a slot
    engine = llm_engine._ENGINE
    conn.close()
    deadline = time.time() + 60
    while time.time() < deadline and (engine._slot_req or engine.queue_depth()):
        time.sleep(0.05)
    assert not engine._slot_req and engine.queue_depth() == 0
    assert engine.stats()["tokens_generated"] < 1024
