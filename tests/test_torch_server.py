"""The port's OpenAI-compatible server: one HTTP round trip per route on
the CPU engine, with the JAX server's wire shapes (the same keys at every
level) and its request defaults."""
import json
import threading
import urllib.error
import urllib.request

import pytest

from generativeaiexamples_tpu.engine import server as jserver
from generativeaiexamples_tpu_torch.config import EngineConfig
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
from generativeaiexamples_tpu_torch.engine.server import make_server


@pytest.fixture(scope="module")
def base():
    engine = LLMEngine(EngineConfig(
        model_config_name="debug", max_batch_size=3, max_seq_len=128, prefill_chunk=16,
        page_size=8, decode_block=4,
    ), device="cpu")
    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="test-http", daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server
    server.shutdown()
    server.server_close()
    thread.join(30)
    assert engine.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _post(url, body, raw=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            data = resp.read().decode()
            return resp.status, resp.headers.get("Content-Type"), data if raw else json.loads(data)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), json.loads(exc.read())


def _keys(obj):
    """Nested key structure of a JSON value (lists by their first item)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__


def test_health_and_models(base):
    url, _ = base
    assert _get(url + "/v1/health/ready") == (200, {"object": "health", "message": "Service is ready."})
    status, body = _get(url + "/v1/models")
    assert status == 200 and body["object"] == "list"
    assert set(body["data"][0]) == {"id", "object", "created", "owned_by"}


def test_chat_non_stream_has_the_jax_wire_shape(base):
    url, server = base
    status, ctype, body = _post(url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6, "temperature": 0})
    assert status == 200 and ctype == "application/json"
    ref = jserver.ModelServer(model_name="m")._chat_body("chatcmpl-x", "text", "stop")
    assert _keys(body) == _keys(ref)
    assert body["choices"][0]["message"]["role"] == "assistant"


def test_chat_stream_is_sse_ending_in_done(base):
    url, server = base
    status, ctype, text = _post(url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8, "stream": True,
        "temperature": 0.7, "seed": 3}, raw=True)
    assert status == 200 and ctype == "text/event-stream"
    frames = [part[len("data: "):] for part in text.split("\n\n") if part]
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[-1]["choices"][0] == {"index": 0, "delta": {}, "finish_reason": "stop"}
    for c in chunks:
        assert set(c) == {"id", "object", "created", "model", "choices"}
        assert c["object"] == "chat.completion.chunk"
    if len(chunks) > 1:
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"


def test_completions(base):
    url, _ = base
    status, _, body = _post(url + "/v1/completions", {"prompt": ["once"], "max_tokens": 5})
    assert status == 200
    assert set(body) == {"id", "object", "created", "model", "choices"}
    assert body["object"] == "text_completion"
    assert set(body["choices"][0]) == {"index", "text", "finish_reason"}


def test_embeddings_wait_for_their_slice(base):
    url, _ = base
    status, _, body = _post(url + "/v1/embeddings", {"input": "x"})
    assert status == 501 and "not served" in body["error"]["message"]


def test_bad_requests(base):
    url, _ = base
    assert _post(url + "/v1/chat/completions", {"nope": 1})[0] == 400
    assert _post(url + "/v1/completions", {"prompt": 3})[0] == 400
    assert _post(url + "/v1/unknown", {})[0] == 404


def test_engine_errors_answer_500(base, monkeypatch):
    url, server = base
    engine = server.RequestHandlerClass.app.engine

    def broken(*args, **kwargs):
        raise RuntimeError("LLM engine failed")

    monkeypatch.setattr(engine, "stream_text", broken)
    status, _, body = _post(url + "/v1/completions", {"prompt": "x", "max_tokens": 2})
    assert status == 500 and body["error"]["type"] == "server_error"


def test_sampling_defaults_match_the_jax_server(base):
    _, server = base
    mine = server.RequestHandlerClass.app.sampling({"stop": "x"})
    ref = jserver.ModelServer()._sampling({"stop": "x"})
    for field in ("temperature", "top_p", "max_tokens", "stop", "seed"):
        assert getattr(mine, field) == getattr(ref, field), field
