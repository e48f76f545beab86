"""The port's streaming-transcript RAG (generativeaiexamples_tpu_torch/
experimental/fm_streaming_rag/) against the JAX repository's
experimental/fm_streaming_rag/ on the CPU:

- the fm_streaming_rag tests of tests/test_experimental_streaming.py on
  the port (the WAV replay through a stdlib stub ASR service);
- ``TimestampDB`` windows, the accumulator's statuses, buffers, timestamp
  rows and stored chunks, and ``classify_intent``/``classify_recency``
  (hypothesis-drawn replies too) equal to JAX's;
- the messages and settings each chain path hands the LLM: equal lists;
- every route of the JAX aiohttp app beside the port's ``http.server``
  app: the same status codes, content types and JSON bodies, SSE bodies
  byte for byte (the ``*error: ...*`` frame and the ``[DONE]`` frame
  included), aiohttp's 404, 405 and 500; the text replay and the WAV
  replay of each package into its own server store the same chunks;
- the slice: ``/generate`` on both apps over each package's LLM backend
  and a recording engine: the same prompt ids and sampling settings; and
  (slow) over a tiny real engine of each package on JAX's weights, greedy
  streams equal wherever the top-1 margin exceeds ``LOGITS_TOL``.
"""
import asyncio
import io
import json
import threading
import time
import urllib.error
import urllib.request
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from hypothesis import given, settings
from hypothesis import strategies as st

from experimental.fm_streaming_rag import TextAccumulator as JAccumulator
from experimental.fm_streaming_rag import TimestampDB as JTimestampDB
from experimental.fm_streaming_rag import chains as jchains
from experimental.fm_streaming_rag import intent as jintent
from experimental.fm_streaming_rag import replay as jreplay
from experimental.fm_streaming_rag.server import create_streaming_app as jcreate_app
from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHash
from generativeaiexamples_tpu.frontend.speech import ASRClient as JASRClient
from generativeaiexamples_tpu.retrieval.store import create_vector_store as jcreate_store
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder as THash
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import TextAccumulator
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import TimestampDB
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import chains as tchains
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import intent as tintent
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag import replay as treplay
from generativeaiexamples_tpu_torch.experimental.fm_streaming_rag.server import (
    create_streaming_app,
)
from generativeaiexamples_tpu_torch.frontend.speech import ASRClient
from generativeaiexamples_tpu_torch.retrieval.store import create_vector_store

LOGITS_TOL = 0.5
SERVER_TIMEOUT = 60  # each request to a test server


class FakeLLM:
    """Scripted LLM: canned JSON for classification, echo for generation;
    records every call with its settings."""

    def __init__(self, intent="SpecificTopic", time_num=5, time_unit="minutes", fail=False):
        self.intent = intent
        self.time_num = time_num
        self.time_unit = time_unit
        self.fail = fail
        self.complete_calls = []
        self.calls = []

    def complete(self, messages, **kwargs):
        self.complete_calls.append(messages)
        self.calls.append(("complete", list(messages), kwargs))
        system = messages[0][1] if messages and messages[0][0] == "system" else ""
        if "intentType" in system:
            return json.dumps({"intentType": self.intent})
        if "timeNum" in system:
            return json.dumps({"timeNum": self.time_num, "timeUnit": self.time_unit})
        return "summary of: " + messages[-1][1][:40]

    def stream_chat(self, messages, **kwargs):
        self.calls.append(("stream_chat", list(messages), kwargs))
        yield "answer about "
        if self.fail:
            raise ValueError("the engine went away")
        yield messages[-1][1][:30]


def _accumulator(chunk_size=12, chunk_overlap=2, port=True):
    if port:
        return TextAccumulator(THash(dimensions=64), create_vector_store("faiss", dimensions=64),
                               chunk_size=chunk_size, chunk_overlap=chunk_overlap)
    return JAccumulator(JHash(dimensions=64), jcreate_store("faiss", dimensions=64),
                        chunk_size=chunk_size, chunk_overlap=chunk_overlap)


def _pair(**kw):
    return _accumulator(port=True, **kw), _accumulator(port=False, **kw)


# --------------------------------------------------------------------------- #
# tests/test_experimental_streaming.py (fm_streaming_rag) on the port


def test_accumulator_buffers_partial_chunks():
    acc = _accumulator(chunk_size=30, chunk_overlap=0)
    assert acc.update("radio-1", "short bit")["status"] == "Added 0 entries"
    acc.update("radio-1", "more text arrives and keeps arriving with many words now")
    assert acc.store.count() > 0
    assert acc.timestamp_db.count() == acc.store.count()
    before = acc.store.count()
    acc.flush("radio-1")
    assert acc.store.count() == before + 1


def test_accumulator_separate_sources():
    acc = _accumulator(chunk_size=20, chunk_overlap=0)
    acc.update("a", "alpha words stream in steadily over time filling chunks")
    acc.update("b", "beta words stream in steadily over time filling chunks")
    assert {"a", "b"} <= set(acc.store.sources())


def test_timestamp_db_recent_and_past():
    db = TimestampDB()
    now = time.time()
    db.insert_docs(["old entry"], "s", tstamp=now - 1000)
    db.insert_docs(["recent entry"], "s", tstamp=now - 10)
    assert [d.content for d in db.recent(now - 60)] == ["recent entry"]
    assert [d.content for d in db.past(now - 1000, window=30)] == ["old entry"]


def test_chain_relevance_path():
    acc = _accumulator(chunk_size=16, chunk_overlap=0)
    acc.update("radio", "the mayor announced a new bridge across the river today")
    acc.flush("radio")
    chain = tchains.StreamingRagChain(FakeLLM(intent="SpecificTopic"), acc,
                                      tchains.StreamingConfig(question="what about the bridge?"))
    out = "".join(chain.answer())
    assert "related entries" in out and "answer about" in out


def test_chain_recent_summary_path():
    acc = _accumulator()
    acc.timestamp_db.insert_docs(["entry one", "entry two"], "radio")
    llm = FakeLLM(intent="RecentSummary", time_num=5, time_unit="minutes")
    out = "".join(tchains.StreamingRagChain(
        llm, acc, tchains.StreamingConfig(question="what happened lately?")).answer())
    assert "entries from the last 300s" in out and "answer about" in out


def test_chain_time_window_path():
    acc = _accumulator()
    acc.timestamp_db.insert_docs(["ten minutes ago item"], "radio", tstamp=time.time() - 600)
    llm = FakeLLM(intent="TimeWindow", time_num=10, time_unit="minutes")
    out = "".join(tchains.StreamingRagChain(
        llm, acc, tchains.StreamingConfig(question="what was said 10 min ago?")).answer())
    assert "600s ago" in out and "answer about" in out


def test_chain_summarization_reduces_context():
    acc = _accumulator(chunk_size=1000)
    acc.timestamp_db.insert_docs([f"entry {i}" for i in range(10)], "radio")
    llm = FakeLLM(intent="RecentSummary", time_num=1, time_unit="hours")
    cfg = tchains.StreamingConfig(question="summarize the last hour", max_docs=3,
                                  allow_summary=True)
    assert "Using summarization" in "".join(tchains.StreamingRagChain(llm, acc, cfg).answer())


def test_intent_falls_back_on_garbage():
    class GarbageLLM(FakeLLM):
        def complete(self, messages, **kwargs):
            return "not json at all"

    assert tintent.classify_intent(GarbageLLM(), "whatever").intentType == "Unknown"
    assert tintent.TimeResponse(timeNum=2, timeUnit="minutes").to_seconds() == 120


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, name="test-app-server", daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(30)

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def _request(base, method, path, body=None, raw=None, headers=None):
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


def test_streaming_server_roundtrip():
    base, stop = _serve(create_streaming_app(_accumulator(chunk_size=16, chunk_overlap=0),
                                             FakeLLM(intent="SpecificTopic")))
    try:
        status, _, body = _request(base, "GET", "/serverStatus")
        assert json.loads(body)["is_ready"] is True
        status, _, _ = _request(base, "POST", "/storeStreamingText", {
            "source_id": "radio",
            "transcript": "breaking news about the harbor expansion project downtown"})
        assert status == 200
        _request(base, "POST", "/flushStream", {"source_id": "radio"})
        status, _, body = _request(base, "POST", "/generate", {"question": "what about the harbor?"})
        assert status == 200 and b"data: " in body and b"[DONE]" in body
    finally:
        stop()


def test_file_replay_word_chunking():
    assert list(treplay.chunk_words("one two three four five", 2)) == \
        ["one two", "three four", "five"]


_TRANSCRIPT = ("storm warning issued for the north harbor at noon today fishing "
               "vessels should return to port before the tide turns this evening")


def _write_wav(path, seconds=6, rate=8000):
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes(b"\x00\x01" * (rate * seconds))


def _asr_stub(total_bytes):
    """A stdlib OpenAI-compatible ``/v1/audio/transcriptions``: the
    transcript's words in proportion to the audio bytes received."""
    from generativeaiexamples_tpu_torch.utils import multipart

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 - http.server's naming
            body = self.rfile.read(int(self.headers["Content-Length"]))
            _, audio = multipart.file_field(self.headers["Content-Type"], body)
            words = _TRANSCRIPT.split()
            n = max(1, int(len(words) * min(1.0, len(audio) / total_bytes)))
            out = json.dumps({"text": " ".join(words[:n])}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    return server


def test_wav_replay_end_to_end_time_scoped_answer(tmp_path):
    """A WAV replays through streaming ASR (partial transcripts through the
    one-shot HTTP contract), the transcript's new text lands in the
    server's accumulator and timestamp database, and a time-scoped question
    answers from the time window."""
    wav_path = tmp_path / "broadcast.wav"
    _write_wav(wav_path)
    chunks = list(treplay.iter_wav_chunks(str(wav_path), chunk_seconds=1.0))
    assert len(chunks) == 6
    with wave.open(io.BytesIO(b"".join(chunks[:2])), "rb") as part:
        assert part.getnframes() > 0
    acc = _accumulator(chunk_size=48, chunk_overlap=0)
    asr_url, stop_asr = _serve(_asr_stub(wav_path.stat().st_size))
    base, stop = _serve(create_streaming_app(
        acc, FakeLLM(intent="RecentSummary", time_num=2, time_unit="minutes")))
    try:
        sent = treplay.replay_audio(str(wav_path), base, ASRClient(server_uri=asr_url),
                                    chunk_seconds=1.0)
        assert sent >= 2, f"expected streaming deltas, got {sent}"
        assert acc.timestamp_db.count() > 0
        _, _, body = _request(base, "POST", "/generate",
                              {"question": "what happened in the last two minutes?"})
        assert b"entries from the last 120s" in body
        assert b"answer about" in body and b"[DONE]" in body
    finally:
        stop()
        stop_asr()


def _decoded_frames(data: bytes) -> int:
    """The frames ``wave`` reads from a (possibly truncated) WAV."""
    with wave.open(io.BytesIO(data), "rb") as wf:
        frame = wf.getnchannels() * wf.getsampwidth()
        return len(wf.readframes(wf.getnframes())) // frame


def test_wav_prefixes_decode_growing_frames(tmp_path):
    """Each accumulated prefix of the replay's chunks decodes to all the
    frames it holds: 1 s of audio a chunk, so k chunks decode to k s.

    A departure from JAX's bytes: JAX's ``iter_wav_chunks`` writes its
    header through ``wave``, which declares the first window's frames
    only, so every prefix of its chunks decodes to the first window
    (8,000 frames here for k = 1, 2 and 5). The port declares the whole
    file's frames in a header of the same 44 bytes; the frames that follow
    are the same bytes in both."""
    wav_path = tmp_path / "broadcast.wav"
    _write_wav(wav_path, seconds=5, rate=8000)
    chunks = list(treplay.iter_wav_chunks(str(wav_path), chunk_seconds=1.0))
    assert len(chunks) == 5
    frames = [_decoded_frames(b"".join(chunks[:k])) for k in range(1, 6)]
    assert frames == [8000 * k for k in range(1, 6)]
    # the whole replay is the file itself, header and all
    assert b"".join(chunks) == wav_path.read_bytes()
    jchunks = list(jreplay.iter_wav_chunks(str(wav_path), chunk_seconds=1.0))
    assert [len(c) for c in jchunks] == [len(c) for c in chunks]
    assert jchunks[0][44:] == chunks[0][44:] and jchunks[1:] == chunks[1:]
    assert [_decoded_frames(b"".join(jchunks[:k])) for k in (1, 2, 5)] == [8000] * 3


# --------------------------------------------------------------------------- #
# against the JAX modules


def _rows(docs):
    return [(d.content, d.tstamp, d.source_id) for d in docs]


def test_timestamp_windows_equal_jax_s():
    rng = np.random.default_rng(5)
    now = 1.7e9
    stamps = now - rng.integers(0, 4000, 40).astype(float)
    t, j = TimestampDB(), JTimestampDB()
    for i, ts in enumerate(stamps):
        for db in (t, j):
            db.insert_docs([f"e{i}a", f"e{i}b"], f"s{i % 3}", tstamp=float(ts))
    assert t.count() == j.count() == 80
    for since in (now - 5000, now - 600, now - 90.0, float(stamps[7]), now):
        assert _rows(t.recent(since)) == _rows(j.recent(since))
    for at, window in ((float(stamps[3]), 90.0), (now - 1000, 30.0), (float(stamps[9]), 0.0)):
        assert _rows(t.past(at, window)) == _rows(j.past(at, window))
    t.close()
    j.close()


def _store_rows(acc, queries):
    hits = [[(h.chunk.text, h.chunk.source, round(h.score, 5))
             for h in acc.store.search(acc.embedder.embed_query(q), 50)] for q in queries]
    ts = [(d.content, d.source_id) for d in acc.timestamp_db.recent(0.0)]
    return acc.store.count(), sorted(acc.store.sources()), hits, ts, dict(acc._buffers)


@pytest.mark.parametrize("chunk_size,overlap", [(12, 2), (30, 0), (64, 8)])
def test_accumulator_equal_jax_s(chunk_size, overlap):
    rng = np.random.default_rng(chunk_size)
    vocab = ["harbor", "storm", "vessel", "tide", "mayor", "bridge", "river", "noon", "port"]
    t, j = _pair(chunk_size=chunk_size, chunk_overlap=overlap)
    for step in range(30):
        source = f"radio-{step % 3}"
        text = " ".join(rng.choice(vocab, int(rng.integers(0, 9))))
        assert t.update(source, text) == j.update(source, text)
    for source in ("radio-0", "radio-1", "nobody"):
        assert t.flush(source) == j.flush(source)
    assert _store_rows(t, vocab) == _store_rows(j, vocab)
    assert t.store.count() > 3


_REPLIES = st.one_of(
    st.text(max_size=40),
    st.lists(st.sampled_from(['{', '}', '"intentType"', '"timeNum"', '"timeUnit"', ':', ',',
                              '"RecentSummary"', '"TimeWindow"', '"minutes"', '"hours"', '5',
                              '2.5', '"x"', 'null', '[', ']', ' ', '\n']),
             max_size=14).map("".join))


class _Reply:
    def __init__(self, text):
        self.text = text

    def complete(self, messages, **kwargs):
        return self.text


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_REPLIES)
def test_classifiers_equal_jax_s_on_drawn_replies(text):
    assert vars(tintent.classify_intent(_Reply(text), "q")) == \
        vars(jintent.classify_intent(_Reply(text), "q"))
    got, want = tintent.classify_recency(_Reply(text), "q"), \
        jintent.classify_recency(_Reply(text), "q")
    assert (got is None) == (want is None)
    if got is not None:
        assert vars(got) == vars(want) and got.to_seconds() == want.to_seconds()


@pytest.mark.parametrize("text", [
    '{"intentType": "RecentSummary"}', 'sure: {"intentType": "TimeWindow"} ok', '{"intentType": 3}',
    '{"timeNum": "5", "timeUnit": "hours"}', '{"timeNum": "x"}', '{"timeNum": [1]}', "{}",
    '{"a": {"intentType": "TimeWindow"}}', "[1]", "", "no json",
])
def test_classifiers_equal_jax_s_on_planted_replies(text):
    assert vars(tintent.classify_intent(_Reply(text), "q")) == \
        vars(jintent.classify_intent(_Reply(text), "q"))
    got, want = tintent.classify_recency(_Reply(text), "q"), \
        jintent.classify_recency(_Reply(text), "q")
    assert (vars(got) if got else got) == (vars(want) if want else want)


def test_prompts_equal_jax_s():
    for name in ("INTENT_TYPES", "INTENT_PROMPT", "RECENCY_PROMPT", "RAG_PROMPT",
                 "SUMMARIZATION_PROMPT", "_UNITS"):
        assert getattr(tintent, name) == getattr(jintent, name), name
    assert tchains.MAX_SUMMARIZATION_ATTEMPTS == jchains.MAX_SUMMARIZATION_ATTEMPTS


_PATHS = {
    "relevance": (dict(intent="SpecificTopic"), {}),
    "no_kb": (dict(), dict(use_knowledge_base=False)),
    "recent": (dict(intent="RecentSummary", time_num=5, time_unit="minutes"), {}),
    "recent_summarized": (dict(intent="RecentSummary", time_num=1, time_unit="hours"),
                          dict(max_docs=3)),
    "past": (dict(intent="TimeWindow", time_num=10, time_unit="minutes"), dict(max_docs=2)),
    "past_no_summary": (dict(intent="TimeWindow", time_num=10, time_unit="minutes"),
                        dict(max_docs=2, allow_summary=False)),
    "bad_unit": (dict(intent="RecentSummary", time_num=2, time_unit="fortnights"), {}),
    "stream_error": (dict(intent="SpecificTopic", fail=True), {}),
}


@pytest.mark.parametrize("path", list(_PATHS))
def test_chain_messages_equal_jax_s(path, monkeypatch):
    llm_kw, cfg_kw = _PATHS[path]
    now = 1.7e9
    monkeypatch.setattr(time, "time", lambda: now)
    outs = []
    for acc, mod in ((_accumulator(chunk_size=40, chunk_overlap=4), tchains),
                     (_accumulator(chunk_size=40, chunk_overlap=4, port=False), jchains)):
        acc.update("radio", "the mayor announced a new bridge across the river today and "
                            "the harbor expansion will finish before the storm season")
        acc.flush("radio")
        for i in range(12):
            acc.timestamp_db.insert_docs([f"entry {i} about the tide"], "radio",
                                         tstamp=now - 50 * i)
        llm = FakeLLM(**llm_kw)
        cfg = mod.StreamingConfig(question="what about the bridge?", temperature=0.3,
                                  max_tokens=40, **cfg_kw)
        tokens = []
        try:
            for token in mod.StreamingRagChain(llm, acc, cfg).answer():
                tokens.append(token)
        except ValueError as exc:
            tokens.append(f"raised {exc}")
        outs.append((tokens, llm.calls))
    assert outs[0] == outs[1]
    assert outs[0][1]


# --------------------------------------------------------------------------- #
# the two apps side by side


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


def _run_port_app(server, requests):
    base, stop = _serve(server)
    try:
        return [_request(base, method, path, body, raw, headers)
                for method, path, body, raw, headers in requests]
    finally:
        stop()


def _assert_same_replies(jax_out, port_out):
    assert len(jax_out) == len(port_out)
    for i, ((js, jh, jb), (ps, ph, pb)) in enumerate(zip(jax_out, port_out)):
        assert ps == js, (i, jb, pb)
        assert ph.get("Content-Type") == jh.get("Content-Type"), i
        assert ph.get("Allow") == jh.get("Allow"), i
        if jb and jh.get("Content-Type", "").startswith("application/json"):
            assert json.loads(pb) == json.loads(jb), i
        else:
            assert pb == jb, i


def _req(method, path, body=None, raw=None, headers=None):
    return (method, path, body, raw, headers)


_STREAM_REQUESTS = [
    _req("GET", "/serverStatus"),
    _req("HEAD", "/serverStatus"),
    _req("POST", "/storeStreamingText", {"source_id": "radio", "transcript": "short"}),
    _req("POST", "/storeStreamingText", {"source_id": "radio", "transcript":
                                         "breaking news about the harbor expansion project "
                                         "downtown é and the new bridge over the river"}),
    _req("POST", "/storeStreamingText", {"transcript": "a default source gets words too"}),
    _req("POST", "/storeStreamingText", {"source_id": 7, "transcript": None}),
    _req("POST", "/flushStream", {"source_id": "radio"}),
    _req("POST", "/flushStream", {}),
    _req("POST", "/flushStream", {"source_id": "radio"}),
    _req("POST", "/generate", {"question": "what about the harbor?"}),
    _req("POST", "/generate", {"question": "q ü <b>", "use_knowledge_base": False,
                               "temperature": 0, "max_tokens": 7}),
    _req("POST", "/generate", {"question": "x", "max_docs": 1, "allow_summary": False}),
    _req("POST", "/generate", raw=b"{not json", headers={"Content-Type": "application/json"}),
    _req("POST", "/generate", raw=b"", headers={"Content-Type": "application/json"}),
    _req("POST", "/storeStreamingText", [1, 2]),
    _req("POST", "/generate", {"question": "q", "max_docs": "many"}),
    _req("GET", "/generate"),
    _req("POST", "/serverStatus", {}),
    _req("DELETE", "/flushStream"),
    _req("GET", "/no/such/route"),
]


@pytest.mark.parametrize("fail", [False, True], ids=["answer", "error_frame"])
def test_routes_equal_jax_app_s(fail):
    jax_out = _run_jax_app(jcreate_app(_accumulator(chunk_size=24, chunk_overlap=0, port=False),
                                       FakeLLM(fail=fail)), _STREAM_REQUESTS)
    port_out = _run_port_app(create_streaming_app(_accumulator(chunk_size=24, chunk_overlap=0),
                                                  FakeLLM(fail=fail)), _STREAM_REQUESTS)
    _assert_same_replies(jax_out, port_out)
    statuses = [s for s, _, _ in port_out]
    assert statuses == [200] * 12 + [500] * 4 + [405, 405, 405, 404]
    sse = port_out[9][2].decode()
    assert sse.endswith('data: {"choices": [{"message": {"content": ""}, '
                        '"finish_reason": "[DONE]"}]}\n\n')
    assert ("*error: the engine went away*" in sse) is fail


def test_text_replay_into_both_apps_stores_the_same_chunks(tmp_path):
    path = tmp_path / "transcript.txt"
    path.write_text(" ".join(f"word{i % 17} tide{i % 5}" for i in range(150)))
    t, j = _pair(chunk_size=48, chunk_overlap=4)
    results = []
    for acc, replay_mod, factory in ((t, treplay, create_streaming_app),
                                     (j, jreplay, None)):
        if factory is not None:
            base, stop = _serve(factory(acc, FakeLLM()))
            try:
                results.append(replay_mod.replay(str(path), base, "feed", 20, 0.0))
            finally:
                stop()
        else:
            results.append(_replay_into_jax_app(replay_mod, str(path), acc))
    assert results[0] == results[1] == 15
    queries = ["word3", "tide2", "word16"]
    assert _store_rows(t, queries) == _store_rows(j, queries)


def _replay_into_jax_app(replay_mod, path, acc):
    async def run():
        async with TestClient(TestServer(jcreate_app(acc, FakeLLM()))) as client:
            base = f"http://{client.host}:{client.port}"
            return await asyncio.get_running_loop().run_in_executor(
                None, lambda: replay_mod.replay(path, base, "feed", 20, 0.0))

    return asyncio.run(run())


def test_wav_replay_equal_jax_s(tmp_path):
    wav_path = tmp_path / "broadcast.wav"
    _write_wav(wav_path, seconds=5)
    asr_url, stop_asr = _serve(_asr_stub(wav_path.stat().st_size))
    t, j = _pair(chunk_size=40, chunk_overlap=0)
    try:
        base, stop = _serve(create_streaming_app(t, FakeLLM()))
        try:
            sent_t = treplay.replay_audio(str(wav_path), base, ASRClient(server_uri=asr_url),
                                          chunk_seconds=1.0)
        finally:
            stop()

        async def run():
            async with TestClient(TestServer(jcreate_app(j, FakeLLM()))) as client:
                jbase = f"http://{client.host}:{client.port}"
                return await asyncio.get_running_loop().run_in_executor(
                    None, lambda: jreplay.replay_audio(str(wav_path), jbase,
                                                       JASRClient(server_uri=asr_url),
                                                       chunk_seconds=1.0))

        sent_j = asyncio.run(run())
    finally:
        stop_asr()
    assert sent_t == sent_j >= 2
    assert _store_rows(t, ["storm", "tide"]) == _store_rows(j, ["storm", "tide"])


# --------------------------------------------------------------------------- #
# the slice: both apps over each package's LLM backend


class _RecordingEngine:
    """An engine stub both packages' backends accept as ``engine=``."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.calls = []

    def stream_text(self, prompt_ids, params=None, timeout=None):
        self.calls.append((list(prompt_ids), params, timeout))
        return iter(["ok"])


def _settings(params):
    return (params.temperature, params.top_p, params.max_tokens, tuple(params.stop))


_GENERATE = [
    _req("POST", "/storeStreamingText", {"source_id": "radio", "transcript":
                                         "the harbor expansion project downtown will finish "
                                         "before the storm season and the new bridge opens"}),
    _req("POST", "/flushStream", {"source_id": "radio"}),
    _req("POST", "/generate", {"question": "what about the harbor?", "temperature": 0.4,
                               "max_tokens": 33, "max_docs": 3}),
    _req("POST", "/generate", {"question": "and é the bridge?", "use_knowledge_base": False}),
]


def test_generate_submits_the_jax_prompt_ids():
    from generativeaiexamples_tpu.engine import llm_backend as jllm
    from generativeaiexamples_tpu.engine import tokenizer as jtok
    from generativeaiexamples_tpu_torch.engine import llm_backend as tllm
    from generativeaiexamples_tpu_torch.engine import tokenizer as ttok

    jeng, teng = _RecordingEngine(jtok.ByteTokenizer()), _RecordingEngine(ttok.ByteTokenizer())
    jax_out = _run_jax_app(jcreate_app(_accumulator(chunk_size=48, chunk_overlap=0, port=False),
                                       jllm.TPULLMBackend(engine=jeng)), _GENERATE)
    port_out = _run_port_app(create_streaming_app(_accumulator(chunk_size=48, chunk_overlap=0),
                                                  tllm.TorchLLMBackend(engine=teng)), _GENERATE)
    _assert_same_replies(jax_out, port_out)
    # the relevance answer (intent, then the stream) and the plain chat
    assert len(teng.calls) == len(jeng.calls) == 3
    for (t_ids, t_params, t_timeout), (j_ids, j_params, j_timeout) in zip(teng.calls, jeng.calls):
        assert t_ids == j_ids
        assert _settings(t_params) == _settings(j_params)
        assert t_timeout is None and j_timeout is None
    assert _settings(teng.calls[0][1]) == (0.0, 0.7, 64, ())
    assert _settings(teng.calls[1][1]) == (0.4, 0.7, 33, ())
    assert b"harbor expansion" in bytes(i for i in teng.calls[1][0] if i < 256)


class _IdsEngine:
    """A real engine behind a recorder of each request's prompt and greedy
    output ids; the backend gets the decoded text in one piece."""

    def __init__(self, engine, params_cls):
        self._engine, self._params_cls = engine, params_cls
        self.tokenizer = engine.tokenizer
        self.calls = []

    def stream_text(self, prompt_ids, params=None, timeout=None):
        params = self._params_cls(temperature=0.0, max_tokens=params.max_tokens)
        ids = list(self._engine.iter_ids(list(prompt_ids), params, timeout=600))
        self.calls.append((list(prompt_ids), ids))
        return iter([self.tokenizer.decode(ids)])


@pytest.mark.slow
def test_generate_on_tiny_engines_equal_jax_s():
    """Both apps over a 2-layer engine of each package, the port's on the
    JAX engine's weights: the same prompts, and greedy streams equal up to
    the first step whose top-1 margin (the port's logits) is within
    LOGITS_TOL, after which the two conversations may part."""
    import jax.numpy as jnp
    import torch

    from generativeaiexamples_tpu.config import EngineConfig as JConfig
    from generativeaiexamples_tpu.engine import llm_backend as jllm
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JEngine
    from generativeaiexamples_tpu.engine.llm_engine import SamplingParams as JParams
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine import llm_backend as tllm
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.models import llama as tl
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(model_config_name="debug-1k", dtype="float32", max_batch_size=2,
                  max_seq_len=1024, prefill_chunk=64, page_size=16, decode_block=4)
    weights = jl.init_params_fast(jl.PRESETS["debug-1k"], 0, jnp.float32)
    jax_engine = JEngine(JConfig(tensor_parallelism=1, kv_layout="paged", **common))
    params = params_from_jax(weights)
    port_engine = LLMEngine(EngineConfig(**common), device="cpu", params=params)
    requests = [_GENERATE[0], _GENERATE[1],
                _req("POST", "/generate", {"question": "what about the harbor?", "temperature": 0,
                                           "max_tokens": 12, "max_docs": 2}),
                _req("POST", "/generate", {"question": "the bridge?", "use_knowledge_base": False,
                                           "temperature": 0, "max_tokens": 12})]
    try:
        jeng, teng = _IdsEngine(jax_engine, JParams), _IdsEngine(port_engine, SamplingParams)
        _run_jax_app(jcreate_app(_accumulator(chunk_size=48, chunk_overlap=0, port=False),
                                 jllm.TPULLMBackend(engine=jeng)), requests)
        _run_port_app(create_streaming_app(_accumulator(chunk_size=48, chunk_overlap=0),
                                           tllm.TorchLLMBackend(engine=teng)), requests)
    finally:
        jax_engine.shutdown()
        port_engine.shutdown()
    assert len(teng.calls) == len(jeng.calls) == 3
    assert teng.calls[0][1] and jeng.calls[0][1]
    cfg = tl.PRESETS["debug-1k"]
    for (t_prompt, t_ids), (j_prompt, j_ids) in zip(teng.calls, jeng.calls):
        assert t_prompt == j_prompt
        if t_ids == j_ids:
            continue
        k = next(i for i, (a, b) in enumerate(zip(t_ids + [None], j_ids + [None])) if a != b)
        seq = torch.tensor([t_prompt + t_ids[:k]])
        with torch.inference_mode():
            logits = tl.forward(params, cfg, seq, torch.arange(seq.shape[1])[None])[0, -1]
        top2 = torch.topk(logits.float(), 2).values
        assert float(top2[0] - top2[1]) <= LOGITS_TOL, (k, t_ids, j_ids)
        break  # the conversations part here: later prompts hold other answers
