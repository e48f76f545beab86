"""The port's OpenAI-compatible server: one HTTP round trip per route on
the CPU engine (and the debug-preset embedder), with the JAX server's wire
shapes (the same keys at every level) and its request defaults; and the
config sections the port reads from the JAX config's environment names.
Embeddings over HTTP equal ``embed_documents`` bit for bit (JSON carries
each f32 as its exact double)."""
import dataclasses
import json
import logging
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from generativeaiexamples_tpu.config.schema import AppConfig
from generativeaiexamples_tpu.config.schema import EngineConfig as JaxEngineConfig
from generativeaiexamples_tpu.engine import server as jserver
from generativeaiexamples_tpu_torch import config as tconfig
import numpy as np
import torch

from generativeaiexamples_tpu_torch.config import JAX_ONLY_FIELDS, EngineConfig
from generativeaiexamples_tpu_torch.engine.embedder import RemoteEmbedder, TorchEmbedder
from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
from generativeaiexamples_tpu_torch.engine.server import make_server


@pytest.fixture(scope="module")
def base():
    engine = LLMEngine(EngineConfig(
        model_config_name="debug", max_batch_size=3, max_seq_len=128, prefill_chunk=16,
        page_size=8, decode_block=4,
    ), device="cpu")
    embedder = TorchEmbedder(model_name="debug", device="cpu")
    server = make_server("127.0.0.1", 0, engine=engine, embedder=embedder)
    thread = threading.Thread(target=server.serve_forever, name="test-http", daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server
    server.shutdown()
    server.server_close()
    thread.join(30)
    embedder.close()
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
    # the LLM and the embed model, as the JAX server lists them
    assert [m["id"] for m in body["data"]] == ["torch-llama", "torch-arctic-embed"]
    for model in body["data"]:
        assert set(model) == {"id", "object", "created", "owned_by"}


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
    """Served since the embedder's slice: 200 with the JAX server's body
    (``embed_documents``, no query prefix), one unit vector per input."""
    url, server = base
    texts = ["first passage", "a second, longer passage about kv caches", "third"]
    status, ctype, body = _post(url + "/v1/embeddings", {"input": texts})
    assert status == 200 and ctype == "application/json"
    assert set(body) == {"object", "model", "data", "usage"}
    assert body["object"] == "list" and body["model"] == "torch-arctic-embed"
    assert [d["index"] for d in body["data"]] == [0, 1, 2]
    assert all(set(d) == {"object", "index", "embedding"} and d["object"] == "embedding"
               for d in body["data"])
    vectors = np.asarray([d["embedding"] for d in body["data"]], np.float32)
    want = server.RequestHandlerClass.app.embedder.embed_documents(texts)
    assert vectors.shape == (3, 64) and np.array_equal(vectors, want)
    np.testing.assert_allclose(np.linalg.norm(vectors, axis=1), 1.0, atol=1e-6)
    status, _, one = _post(url + "/v1/embeddings", {"input": "first passage", "model": "m"})
    assert status == 200 and one["model"] == "m"
    assert np.array_equal(np.asarray(one["data"][0]["embedding"], np.float32), want[0])


@pytest.mark.parametrize("body", [{}, {"input": 3}, {"input": ["ok", 4]}, {"input": None}])
def test_embeddings_bad_body_answers_400(base, body):
    url, _ = base
    assert _post(url + "/v1/embeddings", body)[0] == 400


def test_remote_embedder_round_trips_through_the_server(base):
    url, server = base
    remote = RemoteEmbedder(url, "torch-arctic-embed", dimensions=64)
    local = server.RequestHandlerClass.app.embedder
    texts = ["alpha beta", "gamma"]
    assert np.array_equal(remote.embed_documents(texts), local.embed_documents(texts))
    assert np.array_equal(remote.embed_query("q"),
                          local.embed_documents([remote.query_prefix + "q"])[0])
    assert remote.embed_documents([]).shape == (0, 64)


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


def test_engine_config_reads_the_jax_env_names(monkeypatch):
    """Every field of the port's EngineConfig reads the environment
    variable the JAX config gives the same engine field, with the same
    value: APP_ENGINE_KVCACHEDTYPE=int8 (bench.py's end-to-end default)
    serves an int8 pool."""
    import dataclasses

    from generativeaiexamples_tpu.config.schema import AppConfig

    jax_env = {env: path for env, path, _ in AppConfig.envvars() if path[0] == "engine"}
    for f in dataclasses.fields(EngineConfig):
        assert EngineConfig.env_name(f.name) in jax_env, f.name
    env = {
        "APP_ENGINE_QUANTIZATION": "w8a8", "APP_ENGINE_KVCACHEDTYPE": "int8",
        "APP_ENGINE_MAXBATCHSIZE": "4", "APP_ENGINE_STREAMTIMEOUTS": "5.5",
        "APP_ENGINE_MODELCONFIGNAME": "debug", "APP_ENGINE_PAGESIZE": "16",
    }
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mine = EngineConfig.from_env()
    ref = AppConfig.from_dict({}).engine
    for f in dataclasses.fields(EngineConfig):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert (mine.quantization, mine.kv_cache_dtype, mine.max_batch_size) == ("w8a8", "int8", 4)
    mine.validate()
    monkeypatch.setenv("APP_ENGINE_MAXBATCHSIZE", "many")
    with pytest.raises(ValueError, match="APP_ENGINE_MAXBATCHSIZE"):
        EngineConfig.from_env()


JAX_ENGINE_ENV = sorted(env for env, path, _ in AppConfig.envvars() if path[0] == "engine")
JAX_DEFAULTS = {EngineConfig.env_name(f.name): getattr(JaxEngineConfig(), f.name)
                for f in dataclasses.fields(JaxEngineConfig)}


def test_the_port_knows_all_45_jax_engine_fields():
    port = {EngineConfig.env_name(f.name) for f in dataclasses.fields(EngineConfig)}
    only = {EngineConfig.env_name(name) for name in JAX_ONLY_FIELDS}
    assert len(JAX_ENGINE_ENV) == 45 and not port & only
    assert port | only == set(JAX_ENGINE_ENV) == set(JAX_DEFAULTS)


@pytest.mark.parametrize("env", JAX_ENGINE_ENV)
def test_each_jax_engine_variable_has_the_jax_default(env):
    """Every JAX engine variable is either a port field or in the port's
    own list of the other fields, with the JAX default in both cases."""
    port = {EngineConfig.env_name(f.name): f.default for f in dataclasses.fields(EngineConfig)}
    only = {EngineConfig.env_name(name): spec[0] for name, spec in JAX_ONLY_FIELDS.items()}
    default = port[env] if env in port else only[env]
    assert default == JAX_DEFAULTS[env] and type(default) is type(JAX_DEFAULTS[env])


@pytest.mark.parametrize("env,value,item", [
    ("APP_ENGINE_PAGEDKERNEL", "off", "through its kernel on the card"),
    ("APP_ENGINE_CHUNKEDPREFILL", "off", "always chunks"),
])
def test_from_env_refuses_what_the_port_does_not_serve(env, value, item):
    with pytest.raises(ValueError, match=f"{env}={value}: .*{item}"):
        EngineConfig.from_env({env: value})


@pytest.mark.parametrize("env,field", [
    ("APP_ENGINE_CHECKPOINTPATH", "checkpoint_path"),
    ("APP_ENGINE_SPECDRAFTCHECKPOINTPATH", "spec_draft_checkpoint_path"),
])
def test_from_env_serves_the_checkpoint_paths(env, field, tmp_path):
    """Refused until ROADMAP queue 1 item 10, now served as JAX serves
    them: the variable sets the field; an engine whose path holds no
    safetensors raises FileNotFoundError at build (never random weights);
    a written HF checkpoint of the ``debug`` model is served, its streams
    those of an engine given the same weights in memory."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine, SamplingParams
    from generativeaiexamples_tpu_torch.models import hf_loader, llama

    assert getattr(EngineConfig.from_env({env: "/w"}), field) == "/w"
    draft = field == "spec_draft_checkpoint_path"
    common = dict(model_config_name="debug", dtype="float32", max_batch_size=2, max_seq_len=128,
                  prefill_chunk=16, page_size=8, decode_block=2)
    if draft:  # the preset is the model where the path holds no config.json, as in JAX
        common.update(spec_decode_enable="on", spec_proposer="draft_model",
                      spec_draft_model="debug-draft")
    with pytest.raises(FileNotFoundError):
        LLMEngine(EngineConfig(**common, **{field: str(tmp_path / "missing")}), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    cfg = llama.PRESETS["debug-draft" if draft else "debug"]
    hf_loader.write_hf_checkpoint(cfg, ckpt)
    weights = hf_loader.load_params(ckpt, cfg, torch.float32)
    served = LLMEngine(EngineConfig(**common, **{field: ckpt}), device="cpu")
    given = LLMEngine(EngineConfig(**common), device="cpu",
                      **({"draft_params": weights} if draft else {"params": weights}))
    try:
        prompt, sp = [5, 17, 33, 2, 9], SamplingParams(temperature=0.0, max_tokens=8)
        assert list(served.iter_ids(prompt, sp, timeout=120)) == \
            list(given.iter_ids(prompt, sp, timeout=120))
        if draft:
            assert served._draft.draft_config == cfg
            assert served.stats()["spec_verify_dispatches"] > 0
    finally:
        served.shutdown()
        given.shutdown()


@pytest.mark.parametrize("env,value", [
    ("APP_ENGINE_WARMUPPROMPTLENGTHS", "2048,2560"),  # what bench.py's e2e server sets
    ("APP_ENGINE_SERVINGLAYOUT", "scan"),
    ("APP_ENGINE_QUIESCETIMEOUTS", "5"),
])
def test_from_env_logs_xla_only_variables_once_and_ignores_them(monkeypatch, caplog, env, value):
    monkeypatch.setattr(tconfig, "_LOGGED", set())
    with caplog.at_level(logging.INFO, logger=tconfig.__name__):
        first = EngineConfig.from_env({env: value})
        second = EngineConfig.from_env({env: value})
    assert first == second == EngineConfig()
    assert [r.getMessage().split("=")[0] for r in caplog.records] == [env]


@pytest.mark.parametrize("env,value", sorted(
    [(EngineConfig.env_name(name), str(spec[0])) for name, spec in JAX_ONLY_FIELDS.items()]
    + [("APP_ENGINE_TENSORPARALLELISM", "-1"), ("APP_ENGINE_PREFIXCACHEENABLE", "auto"),
       ("APP_ENGINE_PREFIXCACHESLOTS", "4"), ("APP_ENGINE_DRAINTIMEOUTS", "30.0"),
       ("APP_ENGINE_SNAPSHOTSPOOLDIR", "/tmp/genai_snapshots"),
       ("APP_ENGINE_SNAPSHOTSPOOLMAX", "64"), ("APP_ENGINE_SCHEDULERPOLICY", "unified"),
       ("APP_ENGINE_HANDOFFQUEUEDEPTH", "0")]
    + [(EngineConfig.env_name(f.name), str(f.default)) for f in dataclasses.fields(EngineConfig)
       if f.name.startswith("spec_")]
))
def test_from_env_accepts_jax_defaults_and_what_it_serves_as_it_is(env, value):
    """At its JAX default a variable changes nothing, the prefix cache's,
    the drain's, the scheduler's and tensor parallelism's (every visible
    card) fields included."""
    assert EngineConfig.from_env({env: value}) == EngineConfig()


def test_from_env_serves_the_drain_and_scheduler_fields():
    """The drain, snapshot-spool and scheduler fields read the JAX names,
    away from their defaults too, and their bad values are refused."""
    env = {
        "APP_ENGINE_DRAINTIMEOUTS": "5.5", "APP_ENGINE_SNAPSHOTSPOOLDIR": "/spool",
        "APP_ENGINE_SNAPSHOTSPOOLMAX": "3", "APP_ENGINE_SCHEDULERPOLICY": "disagg",
        "APP_ENGINE_HANDOFFQUEUEDEPTH": "2",
    }
    mine = EngineConfig.from_env(env)
    assert (mine.drain_timeout_s, mine.snapshot_spool_dir, mine.snapshot_spool_max,
            mine.scheduler_policy, mine.handoff_queue_depth) == (5.5, "/spool", 3, "disagg", 2)
    mine.validate()
    for field, value, message in [
        ("scheduler_policy", "pd", "engine.scheduler_policy must be unified|disagg, got 'pd'"),
        ("handoff_queue_depth", -1, "engine.handoff_queue_depth must be >= 0"),
        ("drain_timeout_s", 0.0, "drain_timeout_s must be > 0"),
        ("snapshot_spool_max", 0, "snapshot_spool_max must be >= 1"),
    ]:
        with pytest.raises(ValueError, match=re.escape(message)):
            dataclasses.replace(mine, **{field: value}).validate()


def test_server_engine_comes_from_the_env(monkeypatch):
    """The process engine a server builds on first use is configured by
    the APP_ENGINE_* environment (the port's engine builds on the card,
    so the engine class is replaced by a recorder here)."""
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine.server import ModelServer

    built = []
    monkeypatch.setattr(llm_engine, "_ENGINE", None)
    monkeypatch.setattr(llm_engine, "LLMEngine",
                        lambda config, device=None: built.append(config) or config)
    monkeypatch.setenv("APP_ENGINE_KVCACHEDTYPE", "int4")
    monkeypatch.setenv("APP_ENGINE_QUANTIZATION", "int8")
    engine = ModelServer().engine
    assert built == [engine]
    assert (engine.kv_cache_dtype, engine.quantization) == ("int4", "int8")


def test_from_env_serves_the_runahead_and_admission_fields():
    """The four fields of the pipelined decode and its admission surface
    read the JAX names, with the JAX defaults when unset."""
    env = {
        "APP_ENGINE_DECODERUNAHEAD": "2", "APP_ENGINE_MAXQUEUEDREQUESTS": "16",
        "APP_ENGINE_PREFILLWAVETOKENS": "4096", "APP_ENGINE_WATCHDOGSTALLS": "12.5",
    }
    mine = EngineConfig.from_env(env)
    assert (mine.decode_runahead, mine.max_queued_requests, mine.prefill_wave_tokens,
            mine.watchdog_stall_s) == (2, 16, 4096, 12.5)
    mine.validate()
    ref = JaxEngineConfig()
    default = EngineConfig.from_env({})
    for field in ("decode_runahead", "max_queued_requests", "prefill_wave_tokens", "watchdog_stall_s"):
        assert field not in JAX_ONLY_FIELDS
        assert getattr(default, field) == getattr(ref, field), field
    with pytest.raises(ValueError, match="decode_runahead must be >= 1"):
        EngineConfig.from_env({"APP_ENGINE_DECODERUNAHEAD": "0"}).validate()


class _AdmitGate:
    """Holds an engine's dispatch loop before its next admission until
    ``open()``: submitted requests stay pending and, with work outstanding,
    the loop makes no progress."""

    def __init__(self, engine):
        self.event = threading.Event()
        admit = engine._admit

        def gated():
            assert self.event.wait(60)
            admit()

        engine._admit = gated

    def open(self):
        self.event.set()


def _serve(engine):
    server = make_server("127.0.0.1", 0, engine=engine)
    thread = threading.Thread(target=server.serve_forever, name="test-http-2", daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}", server, thread


def _post_with_headers(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read().decode()


def test_a_full_admission_queue_answers_429():
    """max_queued_requests = max_batch_size = 3, the dispatch loop held:
    three requests wait, and a fourth answers 429 with Retry-After and
    X-GenAI-Queue-Depth in the JAX server's error shape; a stream is
    refused before its first frame. Once the loop runs, the three answer
    200."""
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    engine = LLMEngine(EngineConfig(
        model_config_name="debug", max_batch_size=3, max_seq_len=128, prefill_chunk=16,
        page_size=8, decode_block=4, max_queued_requests=3,
    ), device="cpu")
    url, server, thread = _serve(engine)
    try:
        gate = _AdmitGate(engine)
        waiting = [engine.generate_ids([256, 5, 6], SamplingParams(temperature=0.0, max_tokens=4))
                   for _ in range(3)]
        bodies = [
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
                                      "stream": True}),
            ("/v1/completions", {"prompt": "once", "max_tokens": 4}),
        ]
        for path, body in bodies:
            status, headers, text = _post_with_headers(url + path, body)
            assert status == 429, (path, status, text)
            assert headers["Retry-After"] == "1" and headers["X-GenAI-Queue-Depth"] == "3"
            assert headers["Content-Type"] == "application/json"
            assert json.loads(text) == {"error": {
                "message": "engine admission queue full (3/3 pending)", "type": "overloaded_error"}}
        gate.open()
        for q in waiting:
            while q.get(timeout=60) is not None:
                pass
        status, _, _ = _post(url + "/v1/completions", {"prompt": "once", "max_tokens": 4})
        assert status == 200
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        assert engine.shutdown()


def test_watchdog_flips_readiness_and_recovers():
    """A dispatch loop that stops making progress with a request pending
    (its admission held) marks the engine wedged within watchdog_stall_s:
    /v1/health/ready and /internal/ready answer 503; once the loop runs
    again both recover to 200."""
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams

    engine = LLMEngine(EngineConfig(
        model_config_name="debug", max_batch_size=3, max_seq_len=128, prefill_chunk=16,
        page_size=8, decode_block=4, watchdog_stall_s=0.2,
    ), device="cpu")
    url, server, thread = _serve(engine)
    try:
        assert _get(url + "/internal/ready") == (200, {"ready": True, "wedged": False})
        gate = _AdmitGate(engine)
        q = engine.generate_ids([256, 5, 6], SamplingParams(temperature=0.0, max_tokens=4))
        deadline = time.time() + 30
        while not llm_engine.engine_wedged() and time.time() < deadline:
            time.sleep(0.02)
        assert llm_engine.engine_wedged()
        for path, body in (("/v1/health/ready", {"object": "health", "message": "Engine wedged."}),
                           ("/internal/ready", {"ready": False, "wedged": True})):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(url + path)
            assert err.value.code == 503 and json.loads(err.value.read()) == body
        gate.open()
        while q.get(timeout=60) is not None:
            pass
        deadline = time.time() + 30
        while llm_engine.engine_wedged() and time.time() < deadline:
            time.sleep(0.02)
        assert _get(url + "/v1/health/ready") == (200, {"object": "health", "message": "Service is ready."})
        assert _get(url + "/internal/ready") == (200, {"ready": True, "wedged": False})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        assert engine.shutdown()


def test_internal_ready_needs_a_built_engine():
    """Readiness never builds the engine: a server whose engine is not
    built yet answers 503 with ready false."""
    server = make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, name="test-http-3", daemon=True)
    thread.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(f"http://127.0.0.1:{server.server_address[1]}/internal/ready")
        assert err.value.code == 503
        assert json.loads(err.value.read()) == {"ready": False, "wedged": False}
        assert _get(f"http://127.0.0.1:{server.server_address[1]}/v1/models")[0] == 200
        assert server.RequestHandlerClass.app._engine is None
        assert server.RequestHandlerClass.app._embedder is None  # nor the embedder
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)


def test_ready_routes_of_the_jax_server_exist():
    """The JAX engine server serves the same two readiness routes."""
    app = jserver.ModelServer().build_app()
    routes = {r.resource.canonical for r in app.router.routes() if r.method == "GET"}
    assert {"/v1/health/ready", "/internal/ready"} <= routes


def test_server_embedder_comes_from_the_env(monkeypatch):
    """Without an embedder the server builds the one ``APP_EMBEDDINGS_*``
    configures, on first use."""
    from generativeaiexamples_tpu_torch.engine import embedder as tembedder
    from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder
    from generativeaiexamples_tpu_torch.engine.server import ModelServer

    monkeypatch.setattr(tembedder, "_EMBEDDER_CACHE", {})
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_EMBEDDINGS_DIMENSIONS", "48")
    app = ModelServer()
    assert app._embedder is None
    emb = app.embedder
    assert isinstance(emb, HashEmbedder) and emb.dimensions == 48 and app.embedder is emb


RETRIEVAL_SECTIONS = {
    "embeddings": ("EmbeddingConfig", ["model_name", "model_engine", "dimensions", "server_url",
                                       "checkpoint_path", "query_cache_size"]),
    "ranking": ("RankingConfig", ["model_name", "model_engine", "server_url", "checkpoint_path",
                                  "fetch_factor"]),
    "batching": ("BatchingConfig", ["enable", "max_wait_ms", "max_batch_embed", "max_batch_rerank",
                                    "ingest_decode_yield_ms"]),
    "vector_store": ("VectorStoreConfig", ["name", "url", "nlist", "nprobe", "persist_dir"]),
}


@pytest.mark.parametrize("section", sorted(RETRIEVAL_SECTIONS))
def test_retrieval_sections_have_the_jax_names_defaults_and_env(monkeypatch, section):
    """Each section the port reads has the JAX section's fields (those the
    slice uses), defaults and environment names, and reads the same values
    from the same variables."""
    cls_name, fields = RETRIEVAL_SECTIONS[section]
    mine_cls = getattr(tconfig, cls_name)
    assert [f.name for f in dataclasses.fields(mine_cls)] == fields
    ref = getattr(AppConfig.from_dict({}), section)
    mine = mine_cls.from_env({})
    for field in fields:
        assert getattr(mine, field) == getattr(ref, field), field
    jax_names = {name for name, _, _ in AppConfig.envvars()}
    env = {}
    for field in fields:
        name = tconfig._env_name(section, field)
        assert name in jax_names, name
        env[name] = {str: "x-" + field, int: "7", float: "2.5"}[type(getattr(ref, field))]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jax_read = getattr(AppConfig.from_dict({}), section)
    read = mine_cls.from_env(env)
    for field in fields:
        value = getattr(read, field)
        assert value == getattr(jax_read, field) and value != getattr(ref, field), field
    assert getattr(tconfig.AppConfig.from_env(env), section) == read


@pytest.mark.parametrize("env", ["APP_EMBEDDINGS_CHECKPOINTPATH", "APP_RANKING_CHECKPOINTPATH"])
def test_a_retrieval_checkpoint_path_is_refused(env):
    """Refused until ROADMAP queue 1 item 10; now read as JAX reads it
    (the encoders load it: tests/test_torch_chain_runtime.py)."""
    section = "embeddings" if "EMBEDDINGS" in env else "ranking"
    got = getattr(tconfig.AppConfig.from_env({env: "/w"}), section)
    assert got.checkpoint_path == "/w"
    assert dataclasses.asdict(got) == dataclasses.asdict(
        getattr(AppConfig.from_dict({section: {"checkpoint_path": "/w"}}), section))
    assert tconfig.AppConfig.from_env({env: ""}) == tconfig.AppConfig()


def test_a_retrieval_value_that_does_not_parse_raises():
    with pytest.raises(ValueError, match="APP_BATCHING_MAXBATCHEMBED='many' is not a valid int"):
        tconfig.AppConfig.from_env({"APP_BATCHING_MAXBATCHEMBED": "many"})
