"""The PyTorch port's deploy stack (``generativeaiexamples_tpu_torch/deploy/``)
against JAX's (``deploy/``), on the CPU. Nothing is built, pulled or
downloaded.

- Every JAX compose file that builds or starts the JAX package has its
  counterpart, whose services keep JAX's names, ports, healthcheck paths,
  profiles, dependencies, network and ``APP_*`` names and defaults; the one
  default that departs is named in ``DEPARTURES``.
- Every ``python -m`` module the files start is a module of the port,
  every ``COPY`` source and mounted file exists, every ``APP_*`` name is
  one the port's config reads, a service that holds a model reserves an
  nvidia card and none runs privileged, and no file names the JAX
  package, jax, libtpu or the TPU's device files.
- chip_smoke.py's table of the services its phase 23 starts
  (``DEPLOY_SERVICES``; the GPU machine has no PyYAML) equals
  ``yaml.safe_load`` of the port's compose files, and its ``deploy_service``
  makes only the substitutions it logs.
- The chain server of ``rag-app-text-chatbot.yaml`` and the model server of
  ``docker-compose-gpu-ms.yaml`` boot from their compose command lines
  (resolved by the phase's own ``deploy_service``) with ``--device cpu`` on
  a debug-preset checkpoint in a temporary ``/model-store``; the encoder is
  the debug preset too (``APP_EMBEDDINGS_MODELNAME=debug``: arctic-embed-l
  is not built on this CPU)."""
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time
import urllib.request

import pytest
import yaml

import chip_smoke
from generativeaiexamples_tpu_torch.config import AppConfig, load_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_DEPLOY = ROOT / "deploy"
PORT_DEPLOY = ROOT / "generativeaiexamples_tpu_torch" / "deploy"
PORT_COMPOSE = sorted((PORT_DEPLOY / "compose").glob("*.yaml"))
DOCKERFILES = sorted(PORT_DEPLOY.glob("Dockerfile*"))
# JAX's compose files that name no package stay where they are
SHARED = {"docker-compose-vectordb.yaml", "docker-compose-observability.yaml"}
RENAMED = {"docker-compose-tpu-ms.yaml": "docker-compose-gpu-ms.yaml",
           "docker-compose-tpu-fleet.yaml": "docker-compose-gpu-fleet.yaml"}
# (port file, service, name): (JAX's value, the port's). JAX's empty
# quantization is refused by both packages' config
# (test_jax_model_server_default_is_refused_and_the_port_s_starts)
DEPARTURES = {("docker-compose-gpu-ms.yaml", "tpu-model-server", "APP_ENGINE_QUANTIZATION"):
              ("${APP_ENGINE_QUANTIZATION:-}", "${APP_ENGINE_QUANTIZATION:-none}")}
# the services that hold a model, each of which reserves the card
HOLD_MODELS = {"chain-server", "tpu-model-server", "replica-a", "replica-b", "notebook-server",
               "evaluation", "synthetic-data-generator", "rag-evaluator"}


def _load(path):
    return yaml.safe_load(path.read_text())


def _jax_files():
    return sorted(p.name for p in (JAX_DEPLOY / "compose").glob("*.yaml") if p.name not in SHARED)


def _health(svc):
    test = (svc.get("healthcheck") or {}).get("test") or []
    urls = [t for t in test if str(t).startswith("http")]
    return re.sub(r"^http://localhost", "", urls[0]) if urls else None


def _app_env(svc):
    return {k: str(v) for k, v in (svc.get("environment") or {}).items() if k.startswith("APP_")}


def test_every_jax_file_that_starts_the_package_has_its_counterpart():
    ports = sorted(p.name for p in PORT_COMPOSE)
    assert ports == sorted(RENAMED.get(name, name) for name in _jax_files())
    for name in ("Dockerfile", "Dockerfile.frontend", "Dockerfile.notebooks"):
        assert (PORT_DEPLOY / name).is_file() and (JAX_DEPLOY / name).is_file()
    jax_env = chip_smoke.compose_env(str(JAX_DEPLOY / "compose" / "compose.env"))
    assert chip_smoke.compose_env(str(PORT_DEPLOY / "compose" / "compose.env")) == jax_env


@pytest.mark.parametrize("jax_name", _jax_files())
def test_services_keep_jax_s_names_ports_health_and_app_names(jax_name):
    port_name = RENAMED.get(jax_name, jax_name)
    jax, port = _load(JAX_DEPLOY / "compose" / jax_name), _load(PORT_DEPLOY / "compose" / port_name)
    assert port["networks"] == jax["networks"] == {"default": {"name": "generativeaiexamples-tpu"}}
    assert set(port["services"]) == set(jax["services"])
    for name, want in jax["services"].items():
        got = port["services"][name]
        for key in ("ports", "profiles", "depends_on", "container_name", "restart", "shm_size"):
            assert got.get(key) == want.get(key), (port_name, name, key)
        assert _health(got) == _health(want), (port_name, name)
        want_env, got_env = _app_env(want), _app_env(got)
        assert set(got_env) == set(want_env), (port_name, name)
        for key, value in want_env.items():
            expected = DEPARTURES.get((port_name, name, key), (value, value))
            assert (value, got_env[key]) == expected, (port_name, name, key)
        assert "privileged" not in got and "devices" not in got
        devices = (((got.get("deploy") or {}).get("resources") or {}).get("reservations")
                   or {}).get("devices")
        if name in HOLD_MODELS:
            assert devices and all(d["driver"] == "nvidia" and d["capabilities"] == ["gpu"]
                                   for d in devices), (port_name, name)
        else:
            assert devices is None, (port_name, name)


@pytest.mark.parametrize("path", PORT_COMPOSE, ids=lambda p: p.name)
def test_every_module_started_is_the_port_s(path):
    doc = _load(path)
    for name, svc in doc["services"].items():
        # the command line compose runs: entrypoint, else the image's, then command
        entry, command = svc.get("entrypoint"), svc.get("command")
        if entry is None and "build" in svc:
            entry = chip_smoke.dockerfile_entrypoint(
                str(path.parent / svc["build"]["context"] / svc["build"]["dockerfile"]))
        argv = [str(a) for a in ((entry.split() if isinstance(entry, str) else entry or [])
                                 + (command.split() if isinstance(command, str) else command or []))]
        modules = re.findall(r"(?:^|\s)-m (\S+)", " ".join(argv))
        if argv[:1] == ["python"] or "python -m" in " ".join(argv):
            assert modules, (path.name, name, argv)
        for module in modules:
            assert module.startswith("generativeaiexamples_tpu_torch."), (path.name, name, module)
            assert importlib.util.find_spec(module) is not None, module
        build = svc.get("build")
        if build:
            assert (path.parent / build["context"]).resolve() == ROOT
            assert (ROOT / build["dockerfile"]).resolve().parent == PORT_DEPLOY
        for volume in svc.get("volumes") or []:
            host = volume.split(":")[0]
            if not host.startswith("$"):  # a user's directory, named by a variable
                assert (path.parent / host).exists(), (path.name, name, host)


@pytest.mark.parametrize("path", DOCKERFILES, ids=lambda p: p.name)
def test_dockerfiles_copy_the_port_and_start_its_modules(path):
    text = path.read_text()
    assert re.search(r"^FROM \S+", text, re.M)
    sources = [line.split()[1] for line in re.findall(r"^COPY .*$", text, re.M)]
    assert "generativeaiexamples_tpu_torch" in sources
    for source in sources:  # relative to the build context, the repository's root
        assert (ROOT / source).exists(), source
    entry = chip_smoke.dockerfile_entrypoint(str(path))
    if entry[0] == "python":
        assert entry[1] == "-m" and entry[2].startswith("generativeaiexamples_tpu_torch.")
        assert importlib.util.find_spec(entry[2]) is not None
    else:
        assert any("generativeaiexamples_tpu_torch/notebooks" in arg for arg in entry)
    if "pytorch/pytorch" in text:  # the images that hold models build their kernels
        assert re.search(r"-devel\b", text) and "_build.build()" in text


def test_every_app_name_is_one_the_port_reads():
    buf = io.StringIO()
    AppConfig.print_help(buf.write)
    known = set(re.findall(r"APP_[A-Z0-9_]+", buf.getvalue()))
    used = set()
    for path in PORT_COMPOSE + [PORT_DEPLOY / "compose" / "compose.env"]:
        used |= set(re.findall(r"APP_[A-Z0-9_]+", path.read_text()))
    assert used and used <= known, sorted(used - known)


def _port_files():
    files = [p for p in PORT_DEPLOY.rglob("*") if p.is_file()]
    notebooks = sorted((ROOT / "generativeaiexamples_tpu_torch" / "notebooks").glob("*.ipynb"))
    return files + notebooks


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_the_jax_package_or_the_tpu(path):
    text = path.read_text(encoding="utf-8")
    assert not re.search(r"generativeaiexamples_tpu(?!_torch)", text)
    assert not re.search(r"\bjax\b|libtpu|/dev/accel", text)


TABLE = [(compose, name) for compose, services in chip_smoke.DEPLOY_SERVICES.items()
         for name in services]
TABLE_KEYS = ("build", "entrypoint", "command", "environment", "ports")


@pytest.mark.parametrize("compose,name", TABLE, ids=lambda v: v)
def test_chip_smoke_table_equals_yaml(compose, name):
    doc = _load(PORT_DEPLOY / "compose" / compose)
    svc = doc["services"][name]
    want = {k: svc[k] for k in TABLE_KEYS if k in svc}
    if "healthcheck" in svc:
        want["healthcheck"] = svc["healthcheck"]["test"]
    assert chip_smoke.DEPLOY_SERVICES[compose][name] == want
    # a service of the file that the table leaves out is named in no URL of the
    # table's services, so no address of it needs a substitution
    text = json.dumps(chip_smoke.DEPLOY_SERVICES[compose])
    for other in set(doc["services"]) - set(chip_smoke.DEPLOY_SERVICES[compose]):
        assert f"{other}:" not in text


@pytest.mark.parametrize("compose,name", TABLE, ids=lambda v: v)
def test_deploy_service_makes_only_the_substitutions_it_logs(compose, name, tmp_path):
    ports = {other: chip_smoke._free_port() for other in chip_smoke.DEPLOY_SERVICES[compose]}
    notes = []
    svc = chip_smoke.deploy_service(compose, name, str(tmp_path), ports, note=notes.append)
    assert notes == [f"  {compose} {name}: {line}" for line in svc["substitutions"]]
    assert svc["argv"][0] == sys.executable and svc["argv"][1] == "-m"
    assert svc["argv"][svc["argv"].index("--port") + 1] == str(ports[name])
    # the container paths only under the phase's directory
    text = json.dumps([svc["argv"], svc["env"]]).replace(str(tmp_path) + "/", "<root>/")
    for container in ("0.0.0.0", '"/model-store', '"/tmp-data', "localhost:", "chain-server:"):
        assert container not in text
    if svc["health"] is not None:
        assert svc["health"].startswith(f"http://127.0.0.1:{ports[name]}/")
    if "APP_VECTORSTORE_NAME" in svc["env"]:
        assert svc["env"]["APP_VECTORSTORE_NAME"] == "tpu"
        assert svc["env"]["APP_EMBEDDINGS_CHECKPOINTPATH"] == ""


def _resolved_env(path, service):
    env = chip_smoke.compose_env(str(PORT_DEPLOY / "compose" / "compose.env"))
    svc = _load(path)["services"][service]
    return {k: chip_smoke.compose_interpolate(str(v), env)
            for k, v in (svc.get("environment") or {}).items()}


def test_jax_model_server_default_is_refused_and_the_port_s_starts():
    """JAX's tpu-model-server passes APP_ENGINE_QUANTIZATION="" under its
    compose.env, which the config refuses; the port's passes "none"."""
    jax = _resolved_env(JAX_DEPLOY / "compose" / "docker-compose-tpu-ms.yaml", "tpu-model-server")
    port = _resolved_env(PORT_DEPLOY / "compose" / "docker-compose-gpu-ms.yaml",
                         "tpu-model-server")
    assert jax["APP_ENGINE_QUANTIZATION"] == "" and port["APP_ENGINE_QUANTIZATION"] == "none"
    with pytest.raises(ValueError, match="quantization"):
        load_config(jax).engine.validate()
    load_config(port).engine.validate()
    # the chain servers' environments start too
    for path in PORT_COMPOSE:
        for name, svc in _load(path)["services"].items():
            if svc.get("environment"):
                load_config(_resolved_env(path, name)).engine.validate()


def test_engine_server_takes_device(monkeypatch):
    """``--device`` reaches the engine and the embedder the model server
    builds; without it both go to the card (None)."""
    from generativeaiexamples_tpu_torch.engine import embedder, llm_engine, server

    built = []

    class _Server:
        def serve_forever(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(llm_engine, "get_engine",
                        lambda config=None, device=None: built.append(("engine", device)))
    monkeypatch.setattr(embedder, "create_embedder",
                        lambda config=None, device=None: built.append(("embedder", device)))
    monkeypatch.setattr(server, "make_server", lambda *a, **kw: _Server())
    for key in [k for k in os.environ if k.startswith("APP_")]:
        monkeypatch.delenv(key)
    server.main(["--port", "0", "--device", "cpu"])
    server.main(["--port", "0"])
    assert built == [("engine", "cpu"), ("embedder", "cpu"), ("engine", None), ("embedder", None)]


def _wait(url, proc, log_path, timeout=120.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        assert proc.poll() is None, pathlib.Path(log_path).read_text()[-3000:]
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                if resp.status == 200:
                    return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{url} did not answer in {timeout} s")


def test_compose_services_boot_on_the_cpu(tmp_path):
    from generativeaiexamples_tpu_torch.models import hf_loader, llama

    store = tmp_path / "model-store"
    hf_loader.write_hf_checkpoint(llama.PRESETS["debug"], str(store / "llm"), seed=0)
    os.symlink("llm", store / "Meta-Llama-3-8B-Instruct")
    ports = {name: chip_smoke._free_port() for name in ("chain-server", "rag-playground",
                                                         "tpu-model-server")}
    base = {k: v for k, v in os.environ.items() if not k.startswith("APP_")}
    procs = []
    try:
        services = {}
        for compose, name in (("rag-app-text-chatbot.yaml", "chain-server"),
                              ("docker-compose-gpu-ms.yaml", "tpu-model-server")):
            svc = chip_smoke.deploy_service(compose, name, str(tmp_path), ports, note=lambda _: None)
            assert svc["argv"][1:3] == ["-m", {"chain-server": "generativeaiexamples_tpu_torch.server",
                                               "tpu-model-server":
                                               "generativeaiexamples_tpu_torch.engine.server"}[name]]
            assert svc["env"]["APP_ENGINE_CHECKPOINTPATH"].startswith(str(store))
            log_path = tmp_path / f"{name}.log"
            proc = subprocess.Popen(
                svc["argv"] + ["--device", "cpu"], cwd=ROOT,
                env=dict(base, **dict(svc["env"], APP_EMBEDDINGS_MODELNAME="debug"),
                         CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"),
                stdout=open(log_path, "wb"), stderr=subprocess.STDOUT)
            procs.append(proc)
            services[name] = (svc, proc, log_path)
        for svc, proc, log_path in services.values():
            _wait(svc["health"], proc, log_path)
        chain = f"http://127.0.0.1:{ports['chain-server']}"
        body, ctype = chip_smoke._multipart("dock.txt", chip_smoke.DEPLOY_DOC.encode())
        assert chip_smoke._http(chain, "POST", "/documents", raw=body, ctype=ctype)[0] == 200
        frames, ttft, _ = chip_smoke._generate_stream(chain, chip_smoke.DEPLOY_QUESTIONS[0], True,
                                                      max_tokens=8)
        assert frames[-1]["choices"][0]["finish_reason"] == "[DONE]" and ttft is not None
        assert not chip_smoke._answer(frames).startswith("No response generated from LLM")
        model = f"http://127.0.0.1:{ports['tpu-model-server']}"
        status, text = chip_smoke._http(model, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8})
        assert status == 200 and json.loads(text)["object"] == "chat.completion"
        status, text = chip_smoke._http(model, "POST", "/v1/embeddings", {"input": ["a", "b"]})
        assert status == 200 and len(json.loads(text)["data"]) == 2
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
