"""Two of the port's chain servers (``python -m generativeaiexamples_tpu_torch.server
--device cpu``: ``developer_rag``'s LLM chain over the tiny ``debug-1k``
engine, whose 1,024 positions keep a conversation's history whole, float32,
paged, the prefix cache at its default) behind the port's router, end to end
on the CPU (about 10 s).

- A conversation's turns all land on one replica (``X-GenAI-Replica``), and
  its second turn hits that replica's prefix cache
  (``genai_engine_prefix_cache_hits_total`` rises there, not on the other).
- A stream whose replica drains mid-decode (its dispatch loop slowed by
  ``GENAI_FAULTS``) continues on the sibling through the snapshot relay
  and ``/internal/restore``: the client's text equals the undisturbed
  stream's, no ``PREEMPTED`` frame reaches it, and the router counts one
  ``preempted`` failover. The chain server floors ``temperature`` at 0.1,
  so requests sample at 0.1 with ``top_p`` 0.1: the nucleus is the top
  token alone wherever it holds a tenth of the mass, and two undisturbed
  runs are checked equal first.

Both replicas share one snapshot spool directory: the spool's directory is
part of the engine config's fingerprint, which a restore must match."""
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from generativeaiexamples_tpu_torch.router import metrics as router_metrics
from generativeaiexamples_tpu_torch.router.ring import HashRing

ROOT = pathlib.Path(__file__).resolve().parent.parent
SAMPLING = {"temperature": 0.1, "top_p": 0.1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read()


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _text(body: bytes) -> str:
    out = []
    for block in body.decode().split("\n\n"):
        if block.startswith("data: "):
            for choice in json.loads(block[6:]).get("choices", []):
                out.append((choice.get("message") or {}).get("content") or "")
    return "".join(out)


def _metric(base, name) -> float:
    text = _get(f"{base}/metrics")[1].decode()
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name) and not line.startswith("#"))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    env_common = {
        "EXAMPLE_NAME": "developer_rag", "APP_LLM_MODELENGINE": "tpu",
        "APP_EMBEDDINGS_MODELENGINE": "hash", "APP_RANKING_MODELENGINE": "overlap",
        "APP_ENGINE_MODELCONFIGNAME": "debug-1k", "APP_ENGINE_DTYPE": "float32",
        "APP_ENGINE_MAXSEQLEN": "1024", "APP_ENGINE_PREFILLCHUNK": "32",
        "APP_ENGINE_PAGESIZE": "16", "APP_ENGINE_KVLAYOUT": "paged",
        "APP_ENGINE_MAXBATCHSIZE": "4", "APP_ENGINE_DECODEBLOCK": "2",
        "APP_ENGINE_SNAPSHOTSPOOLDIR": str(tmp / "spool"), "ENABLE_TRACING": "",
        "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1", "GENAI_BLACKBOX": "off",
    }
    procs, bases = [], []
    try:
        for i in range(2):
            port = _free_port()
            env = {k: v for k, v in os.environ.items() if not k.startswith("APP_")}
            env.update(env_common, APP_VECTORSTORE_PERSISTDIR=str(tmp / f"store{i}"),
                       DOC_UPLOAD_DIR=str(tmp / f"up{i}"))
            if i == 0:  # r0 decodes slowly, so a drain lands mid-stream
                env["GENAI_FAULTS"] = "engine.dispatch:delay=0.03@1x0"
            log = open(tmp / f"replica{i}.log", "wb")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "generativeaiexamples_tpu_torch.server", "--host",
                 "127.0.0.1", "--port", str(port), "--device", "cpu"],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
            bases.append(f"http://127.0.0.1:{port}")
        deadline = time.time() + 120
        for proc, base in zip(procs, bases):
            while True:
                assert proc.poll() is None, (tmp / "replica0.log").read_text()[-3000:]
                try:
                    if _get(f"{base}/health", timeout=2)[0] == 200:
                        break
                except OSError:
                    pass
                assert time.time() < deadline, "replica did not start"
                time.sleep(0.2)
        for base in bases:  # build each engine before the router sends traffic
            _post(f"{base}/generate", {"messages": [{"role": "user", "content": "warm"}],
                                       "use_knowledge_base": False, "max_tokens": 2, **SAMPLING})
        yield bases
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


@pytest.fixture
def router(fleet, clean_app_env):
    from generativeaiexamples_tpu_torch.config import AppConfig
    from generativeaiexamples_tpu_torch.router.app import RouterServer

    clean_app_env.setenv("APP_ROUTER_HEALTHINTERVALS", "60")
    rs = RouterServer(AppConfig.from_env(), replica_urls=fleet)
    server = rs.build_server("127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, name="test-router", daemon=True)
    th.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    rs.stop()
    server.shutdown()
    server.server_close()


def _question(owner: str, tag: str) -> str:
    """A first message of more than two prefill chunks whose ring owner is
    ``owner``."""
    for i in range(1000):
        q = f"{tag} {i}: " + "please explain the routing tier and its prefix affinity " * 3
        if HashRing(["r0", "r1"]).owner(q) == owner:
            return q
    raise AssertionError("no key found")


def test_a_conversation_stays_on_its_replica_and_hits_its_prefix_cache(fleet, router):
    q = _question("r1", "conversation")
    hits = "genai_engine_prefix_cache_hits_total"
    before = [_metric(b, hits) for b in fleet]
    messages = [{"role": "user", "content": q}]
    seen = []
    for turn in range(2):
        status, headers, body = _post(f"{router}/generate", {
            "messages": messages, "use_knowledge_base": False, "max_tokens": 8, **SAMPLING})
        assert status == 200 and b'"[DONE]"' in body
        seen.append(headers["X-GenAI-Replica"])
        messages = messages + [{"role": "assistant", "content": _text(body) or "ok"},
                               {"role": "user", "content": f"and follow-up {turn}?"}]
    after = [_metric(b, hits) for b in fleet]
    assert seen == ["r1", "r1"]
    assert after[1] > before[1] and after[0] == before[0]


def test_a_drained_replica_s_stream_continues_on_the_sibling(fleet, router):
    q = _question("r0", "drain")
    body = {"messages": [{"role": "user", "content": q}], "use_knowledge_base": False,
            "max_tokens": 40, **SAMPLING}
    ref = [_post(f"{router}/generate", body) for _ in range(2)]
    assert [r[1]["X-GenAI-Replica"] for r in ref] == ["r0", "r0"]
    assert _text(ref[0][2]) == _text(ref[1][2]) and b'"[DONE]"' in ref[0][2]
    failovers = router_metrics.FAILOVERS.labels(reason="preempted")
    before = failovers.value
    req = urllib.request.Request(f"{router}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            first = resp.readline() + resp.readline()  # one whole frame
            assert first.startswith(b"data: ")
            summary = json.loads(_post(f"{fleet[0]}/internal/drain", {})[2])
            rest = resp.read()
        stream = first + rest
        assert summary["preempted"] >= 1 and summary["spooled"] >= 1
        assert b"PREEMPTED" not in stream and b'"[DONE]"' in stream
        assert _text(stream) == _text(ref[0][2])
        assert failovers.value == before + 1
    finally:
        _post(f"{fleet[0]}/internal/drain", {"resume": True})
