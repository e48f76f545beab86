"""The port's O-RAN chatbot, multimodal assistant and five-minute RAG
(generativeaiexamples_tpu_torch/experimental/{oran_chatbot,
multimodal_assistant}/, examples/five_min_rag.py) against the JAX
repository's on the CPU:

- the oran_chatbot and multimodal_assistant tests of
  tests/test_experimental_agents.py on the port;
- ``parse_verdict`` on planted and hypothesis-drawn replies, the
  fact-check, summary-memory and feedback-log calls and records, equal to
  JAX's;
- every route of the JAX aiohttp chatbot beside the port's
  ``http.server`` one (the multipart upload with its 422, the chat with
  and without the fact check through five turns of memory, the feedback
  and its summary, aiohttp's 404, 405 and 500): the same status codes and
  JSON bodies, and the same messages handed to the LLM;
- the multimodal assistant over both runtimes (echo LLM, hash
  embeddings): the same documents and the same answers;
- the slice: ``five_min_rag.build_store`` and ``answer`` over each
  package's LLM backend and a recording engine, the same prompt ids and
  sampling settings and the same printed text; ``main`` of both packages
  in process prints the same;
- the new modules import no JAX, no aiohttp or requests and neither the
  root ``experimental`` nor ``tools`` package, and every model-building
  entry point raises with no card and no ``--device``.
"""
import asyncio
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

from experimental.oran_chatbot import app as japp
from experimental.oran_chatbot import feedback as jfeedback
from experimental.oran_chatbot import guardrails as jguard
from experimental.oran_chatbot import memory as jmemory
from generativeaiexamples_tpu.chains import runtime as jruntime
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHash
from generativeaiexamples_tpu.retrieval.store import create_vector_store as jcreate_store
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import runtime as truntime
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder as THash
from generativeaiexamples_tpu_torch.examples import five_min_rag as tfive
from generativeaiexamples_tpu_torch.experimental.oran_chatbot import app as tapp
from generativeaiexamples_tpu_torch.experimental.oran_chatbot import feedback as tfeedback
from generativeaiexamples_tpu_torch.experimental.oran_chatbot import guardrails as tguard
from generativeaiexamples_tpu_torch.experimental.oran_chatbot import memory as tmemory
from generativeaiexamples_tpu_torch.retrieval.store import create_vector_store
from generativeaiexamples_tpu_torch.utils import multipart

ROOT = pathlib.Path(__file__).resolve().parent.parent
SERVER_TIMEOUT = 60  # each request to a test server


def _jax_five_min_rag():
    spec = importlib.util.spec_from_file_location("jax_five_min_rag",
                                                  ROOT / "examples" / "five_min_rag.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ScriptedLLM:
    """Returns queued responses in order (repeats the last); records every
    call with its settings."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def complete(self, messages, **kwargs):
        self.calls.append(("complete", list(messages), kwargs))
        if len(self.responses) > 1:
            return self.responses.pop(0)
        return self.responses[0]

    def stream_chat(self, messages, **kwargs):
        self.calls.append(("stream_chat", list(messages), kwargs))
        yield self.complete(messages, **kwargs)
        self.calls.pop()  # the inner complete is not a call of its own


class OranLLM(ScriptedLLM):
    def complete(self, messages, **kwargs):
        self.calls.append(("complete", list(messages), kwargs))
        system = messages[0][1] if messages else ""
        if "Fact-check" in system:
            return "TRUE — supported." if "timing" in messages[-1][1] else "FALSE: invented."
        if "Condense" in system:
            return f"summary of {len(messages[-1][1])} characters"
        return "The spec defines timing in section 3."


# --------------------------------------------------------------------------- #
# tests/test_experimental_agents.py (oran_chatbot, multimodal_assistant) on the port


def test_fact_check_verdicts():
    passing = ScriptedLLM(["TRUE — every claim is supported by the context."])
    assert tguard.fact_check(passing, "evidence", "q", "resp").passed is True
    failing = ScriptedLLM(["FALSE: the response invents a frequency band."])
    result = tguard.fact_check(failing, "evidence", "q", "resp")
    assert result.passed is False and "invents" in result.explanation
    assert tguard.parse_verdict("**TRUE** fine").passed is True
    assert tguard.parse_verdict("nonsense").passed is False


def test_feedback_log(tmp_path):
    log = tfeedback.FeedbackLog(str(tmp_path / "fb.jsonl"))
    log.record("q1", "a1", rating=1)
    log.record("q2", "a2", rating=-1, comment="wrong")
    assert log.summary() == {"total": 2, "up": 1, "down": 1}
    assert log.entries()[1]["comment"] == "wrong"


def test_summary_memory_compacts():
    memory = tmemory.SummaryMemory(ScriptedLLM(["condensed history"]), keep_last=2,
                                   summarize_after=4)
    for i in range(5):
        memory.add("user", f"turn {i}")
    assert memory.summary == "condensed history"
    ctx = memory.context()
    assert "condensed history" in ctx and "turn 4" in ctx and "turn 0" not in ctx
    memory.clear()
    assert memory.context() == ""


def _serve(server):
    import threading

    thread = threading.Thread(target=server.serve_forever, name="test-app-server", daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(30)

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def _request(base, method, path, body=None, raw=None, headers=None):
    import urllib.error
    import urllib.request

    if body is not None:
        raw = json.dumps(body).encode()
        headers = {"Content-Type": "application/json", **(headers or {})}
    req = urllib.request.Request(base + path, data=raw, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=SERVER_TIMEOUT) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        with exc:
            return exc.code, dict(exc.headers), exc.read()


def test_oran_app_chat_with_fact_check(tmp_path):
    server = tapp.create_oran_app(
        llm=OranLLM([""]), embedder=THash(dimensions=32),
        store=create_vector_store("faiss", dimensions=32),
        feedback_path=str(tmp_path / "fb.jsonl"))
    base, stop = _serve(server)
    try:
        raw, ctype = multipart.encode(files={"file": (
            "spec.txt", b"Section 3 defines timing requirements for the fronthaul.")})
        status, _, _ = _request(base, "POST", "/documents", raw=raw, headers={"Content-Type": ctype})
        assert status == 200
        status, _, body = _request(base, "POST", "/chat",
                                   {"question": "what about timing?", "fact_check": True})
        body = json.loads(body)
        assert status == 200 and "timing" in body["answer"]
        assert body["fact_check"]["passed"] is True
        assert body["sources"] == ["spec.txt"]
        status, _, _ = _request(base, "POST", "/feedback",
                                {"question": "q", "answer": body["answer"], "rating": 1})
        assert status == 200
        assert json.loads(_request(base, "GET", "/feedback/summary")[2])["up"] == 1
    finally:
        stop()


@pytest.fixture
def app_env(monkeypatch, tmp_path):
    """A clean APP_* environment (the echo LLM, hash embeddings, the faiss
    store), each package's store under its own directory; the port's
    runtime on the CPU."""
    for key in list(os.environ):
        if key.startswith("APP_") or key in ("EXAMPLE_NAME", "DOC_UPLOAD_DIR", "COLLECTION_NAME"):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_LLM_MODELENGINE", "echo")
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_VECTORSTORE_NAME", "faiss")
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device("cpu")
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "jax"))
    jcfg = jget_config()
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "port"))
    tcfg = tconfig.get_config()
    yield jcfg, tcfg
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device(None)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


def test_multimodal_assistant_ingest_and_ask(app_env, tmp_path):
    from generativeaiexamples_tpu_torch.experimental.multimodal_assistant import (
        MultimodalAssistant,
    )

    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "doc.txt").write_text("the antenna array uses beamforming " * 10)
    assistant = MultimodalAssistant()
    assert assistant.ingest_directory(str(tmp_path / "docs")) == ["doc.txt"]
    assert "doc.txt" in assistant.documents()
    assert "".join(str(t) for t in assistant.ask("what about beamforming?"))


# --------------------------------------------------------------------------- #
# against the JAX modules


_VERDICTS = ["TRUE", "true.", "**TRUE** fine", "  - FALSE", "False", "", "NOT TRUE",
             "The answer is TRUE", "1. TRUE", "TRUEish", "x" * 70 + "TRUE", "Ünïcode TRUE",
             "ß TRUE", "ﬁ TRUE"]


@pytest.mark.parametrize("text", _VERDICTS)
def test_parse_verdict_equal_jax_s_on_planted_replies(text):
    assert vars(tguard.parse_verdict(text)) == vars(jguard.parse_verdict(text))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.one_of(st.text(max_size=80),
                 st.lists(st.sampled_from(["TRUE", "FALSE", "true", "*", " ", "\n", "-", "1.",
                                           "é", "ß", "x"]), max_size=12).map("".join)))
def test_parse_verdict_equal_jax_s_on_drawn_replies(text):
    assert vars(tguard.parse_verdict(text)) == vars(jguard.parse_verdict(text))


def test_guardrail_memory_and_feedback_equal_jax_s(tmp_path, monkeypatch):
    assert tguard.FACT_CHECK_PROMPT == jguard.FACT_CHECK_PROMPT
    assert tmemory.SUMMARY_PROMPT == jmemory.SUMMARY_PROMPT
    t_llm, j_llm = ScriptedLLM(["FALSE: no."]), ScriptedLLM(["FALSE: no."])
    assert vars(tguard.fact_check(t_llm, "ev", "q", "r")) == \
        vars(jguard.fact_check(j_llm, "ev", "q", "r"))
    assert t_llm.calls == j_llm.calls
    t_llm, j_llm = ScriptedLLM(["s1", "s2", "s3"]), ScriptedLLM(["s1", "s2", "s3"])
    t_mem, j_mem = tmemory.SummaryMemory(t_llm, 3, 5), jmemory.SummaryMemory(j_llm, 3, 5)
    for i in range(14):
        for mem in (t_mem, j_mem):
            mem.add("user" if i % 2 else "assistant", f"turn {i}")
        assert t_mem.context() == j_mem.context()
    assert t_llm.calls == j_llm.calls and len(t_llm.calls) == 3
    clock = types.SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(tfeedback, "time", clock)
    monkeypatch.setattr(jfeedback, "time", clock)
    logs = (tfeedback.FeedbackLog(str(tmp_path / "t" / "fb.jsonl")),
            jfeedback.FeedbackLog(str(tmp_path / "j" / "fb.jsonl")))
    for log in logs:
        assert log.summary() == {"total": 0, "up": 0, "down": 0}
    for args in (("q", "a", 1), ("q2", "a2", -1, "bad", ["s.txt"]), ("q3", "a3", 0)):
        assert logs[0].record(*args) == logs[1].record(*args)
    assert logs[0].entries() == logs[1].entries()
    assert logs[0].summary() == logs[1].summary() == {"total": 3, "up": 1, "down": 1}
    assert (tmp_path / "t" / "fb.jsonl").read_bytes() == (tmp_path / "j" / "fb.jsonl").read_bytes()


def _form(*fields):
    """aiohttp's multipart body of file ``fields`` ((name, filename,
    bytes)), as both servers get it."""
    form = FormData()
    for name, filename, data in fields:
        form.add_field(name, data, filename=filename, content_type="text/plain")
    payload = form()
    return b"".join(_chunks(payload)), payload.content_type


def _chunks(payload):
    out = []

    class _Writer:
        async def write(self, data):
            out.append(bytes(data))

    asyncio.run(payload.write(_Writer()))
    return out


_SPEC = b"Section 3 defines timing requirements for the fronthaul. " * 4
_OTHER = b"Clause 7 lists the frequency bands of the radio unit and their power limits."


def _oran_requests():
    up, up_ct = _form(("file", "spec.txt", _SPEC))
    md, md_ct = _form(("file", "notes.md", b"# Bands\n\n" + _OTHER))
    nameless, nameless_ct = multipart.encode(fields={"file": "a plain field, no filename"})
    wrong, wrong_ct = _form(("document", "spec.txt", _SPEC), ("file", "x.txt", b"x"))
    empty_ct = "multipart/form-data; boundary=b0undary"
    reqs = [
        ("POST", "/documents", None, up, {"Content-Type": up_ct}),
        ("POST", "/documents", None, md, {"Content-Type": md_ct}),
        ("POST", "/documents", None, nameless, {"Content-Type": nameless_ct}),
        ("POST", "/documents", None, wrong, {"Content-Type": wrong_ct}),
        ("POST", "/documents", None, b"--b0undary--\r\n", {"Content-Type": empty_ct}),
        ("POST", "/documents", {"file": "x"}, None, None),
    ]
    for i in range(5):
        reqs.append(("POST", "/chat", {"question": f"what about timing? {i}",
                                       "fact_check": i % 2 == 0, "top_k": 2 + i % 2}, None, None))
    reqs += [
        ("POST", "/chat", {"question": "bands?"}, None, None),
        ("POST", "/chat", None, b"{oops", {"Content-Type": "application/json"}),
        ("POST", "/feedback", {"question": "q", "answer": "a", "rating": 1}, None, None),
        ("POST", "/feedback", {"question": "q", "answer": "a", "rating": -1, "comment": "no",
                               "sources": ["spec.txt"]}, None, None),
        ("POST", "/feedback", {"rating": "x"}, None, None),
        ("GET", "/feedback/summary", None, None, None),
        ("HEAD", "/feedback/summary", None, None, None),
        ("GET", "/chat", None, None, None),
        ("PUT", "/feedback/summary", None, None, None),
        ("GET", "/nowhere", None, None, None),
    ]
    return reqs


def _run_jax_app(app, requests):
    async def run():
        async with TestClient(TestServer(app)) as client:
            out = []
            for method, path, body, raw, headers in requests:
                data = json.dumps(body).encode() if body is not None else raw
                hdrs = dict(headers or {})
                if body is not None:
                    hdrs.setdefault("Content-Type", "application/json")
                resp = await client.request(method, path, data=data, headers=hdrs)
                out.append((resp.status, dict(resp.headers), await resp.read()))
            return out

    return asyncio.run(run())


def test_oran_routes_equal_jax_app_s(app_env, tmp_path, monkeypatch):
    clock = types.SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(tfeedback, "time", clock)
    monkeypatch.setattr(jfeedback, "time", clock)
    reqs = _oran_requests()
    j_llm, t_llm = OranLLM([""]), OranLLM([""])
    jax_out = _run_jax_app(japp.create_oran_app(
        llm=j_llm, embedder=JHash(dimensions=32), store=jcreate_store("faiss", dimensions=32),
        feedback_path=str(tmp_path / "j" / "fb.jsonl")), reqs)
    base, stop = _serve(tapp.create_oran_app(
        llm=t_llm, embedder=THash(dimensions=32), store=create_vector_store("faiss", dimensions=32),
        feedback_path=str(tmp_path / "t" / "fb.jsonl")))
    try:
        port_out = [_request(base, *r[:2], body=r[2], raw=r[3], headers=r[4]) for r in reqs]
    finally:
        stop()
    assert len(port_out) == len(jax_out)
    for i, ((js, jh, jb), (ps, ph, pb)) in enumerate(zip(jax_out, port_out)):
        assert ps == js, (i, jb, pb)
        assert ph.get("Content-Type") == jh.get("Content-Type"), i
        assert ph.get("Allow") == jh.get("Allow"), i
        assert (json.loads(pb) if pb and js == 200 else pb) == \
            (json.loads(jb) if jb and js == 200 else jb), i
    assert [s for s, _, _ in port_out] == \
        [200, 200, 200, 422, 422, 500] + [200] * 6 + [500, 200, 200, 500, 200, 200, 405, 405, 404]
    assert json.loads(port_out[6][2])["fact_check"]["passed"] is True
    assert json.loads(port_out[16][2]) == {"total": 2, "up": 1, "down": 1}
    assert t_llm.calls == j_llm.calls
    assert any("Condense" in m[0][1] for _, m, _ in t_llm.calls)  # the memory compacted


def test_multimodal_assistant_equal_jax_s(app_env, tmp_path, capsys):
    from experimental.multimodal_assistant import app as jmm
    from generativeaiexamples_tpu_torch.experimental.multimodal_assistant import app as tmm
    from generativeaiexamples_tpu_torch.retrieval.pdf import write_text_pdf

    docs = tmp_path / "docs"
    (docs / "sub").mkdir(parents=True)
    (docs / "doc.txt").write_text("the antenna array uses beamforming " * 40)
    (docs / "sub" / "notes.md").write_text("# Timing\n\nthe fronthaul timing budget is 25 us " * 20)
    (docs / "spec.pdf").write_bytes(write_text_pdf(["Clause 7 lists the bands.",
                                                    "The radio unit transmits at 40 W."]))
    (docs / "empty.txt").write_text("   ")
    got = tmm.MultimodalAssistant()
    want = jmm.MultimodalAssistant()
    assert got.ingest_directory(str(docs)) == want.ingest_directory(str(docs))
    assert sorted(got.documents()) == sorted(want.documents()) == \
        ["doc.txt", "notes.md", "spec.pdf"]
    for question, kb in (("what about beamforming?", True), ("the timing budget?", True),
                         ("hello there", False)):
        assert [str(t) for t in got.ask(question, kb)] == [str(t) for t in want.ask(question, kb)]
    capsys.readouterr()
    assert tmm.main(["--docs", str(docs), "--ask", "bands?", "--ask", "power?",
                     "--device", "cpu"]) == 0
    t_out = capsys.readouterr()
    assert jmm.main(["--docs", str(docs), "--ask", "bands?", "--ask", "power?"]) == 0
    j_out = capsys.readouterr()
    assert t_out.out == j_out.out and "Q: power?" in t_out.out
    assert t_out.err == j_out.err


# --------------------------------------------------------------------------- #
# the slice: five_min_rag over each package's backend


class _RecordingEngine:
    """An engine stub both packages' backends accept as ``engine=``."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.calls = []

    def stream_text(self, prompt_ids, params=None, timeout=None):
        self.calls.append((list(prompt_ids), params, timeout))
        return iter(["ok ", "done"])


def _settings(params):
    return (params.temperature, params.top_p, params.max_tokens, tuple(params.stop))


def _write_docs(root):
    (root / "nested").mkdir(parents=True)
    (root / "a.txt").write_text(" ".join(f"alpha{i % 13} beamforming" for i in range(700)))
    (root / "nested" / "b.md").write_text("# Bands\n\n" + "clause seven lists the bands " * 90)
    (root / "bad.pdf").write_bytes(b"not a pdf")
    (root / "blank.txt").write_text("")


def test_five_min_rag_submits_the_jax_prompt_ids(app_env, tmp_path, capsys):
    from generativeaiexamples_tpu.engine import llm_backend as jllm
    from generativeaiexamples_tpu.engine import tokenizer as jtok
    from generativeaiexamples_tpu_torch.engine import llm_backend as tllm
    from generativeaiexamples_tpu_torch.engine import tokenizer as ttok

    jfive = _jax_five_min_rag()
    assert tfive.PROMPT == jfive.PROMPT
    _write_docs(tmp_path / "docs")
    outs = []
    for mod, emb, backend, tok in ((tfive, THash(dimensions=64), tllm.TorchLLMBackend, ttok),
                                   (jfive, JHash(dimensions=64), jllm.TPULLMBackend, jtok)):
        store = mod.build_store(str(tmp_path / "docs"), emb)
        engine = _RecordingEngine(tok.ByteTokenizer())
        for question in ("what do the clauses list?", "beamforming é?"):
            mod.answer(question, store, emb, backend(engine=engine), top_k=3)
        printed = capsys.readouterr()
        outs.append((store.count(), printed.out, printed.err,
                     [(ids, _settings(p), t) for ids, p, t in engine.calls]))
    assert outs[0] == outs[1]
    count, out, err, calls = outs[0]
    assert f"Knowledge base ready: 2 files, {count} chunks." in err
    assert out == "ok done\nok done\n"
    assert len(calls) == 2 and calls[0][1] == (0.2, 0.7, 512, ())
    assert b"clause seven" in bytes(i for i in calls[0][0] if i < 256)


def test_five_min_rag_main_equal_jax_s(app_env, tmp_path, capsys, monkeypatch):
    jfive = _jax_five_min_rag()
    _write_docs(tmp_path / "docs")
    argv = ["--docs", str(tmp_path / "docs"), "-q", "what do the clauses list?", "--top-k", "2"]
    assert tfive.main(argv + ["--device", "cpu"]) == 0
    t_out = capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["five_min_rag.py"] + argv)
    assert jfive.main() == 0
    j_out = capsys.readouterr()
    assert (t_out.out, t_out.err) == (j_out.out, j_out.err)
    assert "Knowledge base ready: 2 files" in t_out.err and t_out.out.strip()


# --------------------------------------------------------------------------- #
# isolation and the device rule


NEW_MODULES = [
    "generativeaiexamples_tpu_torch.tools.evaluation.synthetic_data_generator",
    "generativeaiexamples_tpu_torch.tools.evaluation.evaluator",
    "generativeaiexamples_tpu_torch.tools.evaluation.answer_generator",
    "generativeaiexamples_tpu_torch.tools.evaluation.main",
    "generativeaiexamples_tpu_torch.examples.five_min_rag",
    "generativeaiexamples_tpu_torch.experimental.http_app",
    "generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.timestamps",
    "generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.accumulator",
    "generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.intent",
    "generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.chains",
    "generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.server",
    "generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.replay",
    "generativeaiexamples_tpu_torch.experimental.oran_chatbot.guardrails",
    "generativeaiexamples_tpu_torch.experimental.oran_chatbot.memory",
    "generativeaiexamples_tpu_torch.experimental.oran_chatbot.feedback",
    "generativeaiexamples_tpu_torch.experimental.oran_chatbot.app",
    "generativeaiexamples_tpu_torch.experimental.multimodal_assistant.app",
]
ROOT_PACKAGES = ("jax", "generativeaiexamples_tpu", "aiohttp", "requests", "experimental", "tools",
                 "integrations")


def test_the_new_modules_import_no_jax_and_no_root_package():
    code = ("import importlib, json, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(NEW_MODULES) <= set(loaded)
    assert [m for m in loaded if m.split(".")[0] in ROOT_PACKAGES] == []


def test_entry_points_raise_with_no_card_and_no_device(app_env, tmp_path, monkeypatch):
    from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import server as tstream
    from generativeaiexamples_tpu_torch.experimental.multimodal_assistant import app as tmm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    truntime.set_device(None)
    (tmp_path / "docs").mkdir()
    calls = [
        lambda: tfive.main(["--docs", str(tmp_path / "docs"), "-q", "x"]),
        lambda: tstream.main(["--host", "127.0.0.1", "--port", "0"]),
        lambda: tapp.main(["--host", "127.0.0.1", "--port", "0"]),
        lambda: tmm.main(["--docs", str(tmp_path / "docs"), "--ask", "x"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
