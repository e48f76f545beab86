"""The port's configuration file (generativeaiexamples_tpu_torch/config.py
``AppConfig.from_file``/``from_dict``/``load_config``/``get_config`` over
config_wizard.py) against the JAX package's (config/wizard.py and
config/__init__.py ``get_config``).

The same JSON and YAML files and the same ``APP_*`` environment go to both
packages, and every field the port has must come out equal, field by
field: camelCase and snake_case keys, the environment over the file, a
missing or unreadable file (the environment alone), YAML's booleans. A
value the port does not serve is refused from a file with the message the
same value gets from the environment. The environment names and the
``print_help`` rows of the fields both packages have are equal. Exact
comparisons: no tolerance applies.
"""
import dataclasses
import json
import os

import pytest
import yaml

from generativeaiexamples_tpu import config as jconfig
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch import config_wizard



@pytest.fixture(autouse=True)
def env(monkeypatch):
    """No APP_* variable but those a case sets; both cached configs
    dropped before and after."""
    for key in list(os.environ):
        if key.startswith("APP_"):
            monkeypatch.delenv(key)
    jconfig.get_config.cache_clear()
    tconfig.get_config.cache_clear()
    yield monkeypatch
    jconfig.get_config.cache_clear()
    tconfig.get_config.cache_clear()


def _served():
    """(section, field, default) of every field the port serves."""
    out = []
    for section in dataclasses.fields(tconfig.AppConfig):
        for f in dataclasses.fields(section.default_factory):
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            out.append((section.name, f.name, default))
    return out


def _other(value, i):
    """A value of the default's type away from the default."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 2 + i % 5
    if isinstance(value, float):
        return value + 0.25 * (1 + i % 3)
    return f"{value}-x{i}"


def _document(snake=False):
    """A nested file document setting every served field away from its
    default, under camelCase keys (or snake_case ones)."""
    data = {}
    key = (lambda n: n) if snake else config_wizard.to_camel_case
    for i, (section, name, default) in enumerate(_served()):
        data.setdefault(key(section), {})[key(name)] = _other(default, i)
    return data


def _fields_equal(tcfg, jcfg):
    """Every served field of the port's config against JAX's."""
    diff = {}
    for section, name, _ in _served():
        got, want = getattr(getattr(tcfg, section), name), getattr(getattr(jcfg, section), name)
        if got != want or type(got) is not type(want):
            diff[f"{section}.{name}"] = (got, want)
    return diff


def _write(tmp_path, data, fmt):
    path = tmp_path / f"app.{fmt}"
    path.write_text(json.dumps(data) if fmt == "json" else yaml.safe_dump(data))
    return str(path)


@pytest.mark.parametrize("fmt", ["json", "yaml"])
@pytest.mark.parametrize("snake", [False, True], ids=["camel", "snake"])
def test_every_field_from_a_file_is_jax_s(tmp_path, fmt, snake):
    path = _write(tmp_path, _document(snake), fmt)
    tcfg, jcfg = tconfig.AppConfig.from_file(path), jconfig.AppConfig.from_file(path)
    assert _fields_equal(tcfg, jcfg) == {}
    # and the file really moved them: no field is left at its default
    default = tconfig.AppConfig()
    moved = {(s, n) for s, n, _ in _served()
             if getattr(getattr(tcfg, s), n) != getattr(getattr(default, s), n)}
    assert moved == {(s, n) for s, n, _ in _served()}


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_get_config_reads_the_file_then_the_environment_on_top(env, tmp_path, fmt):
    path = _write(tmp_path, {"vectorStore": {"name": "faiss", "persistDir": "/data/vs"},
                             "retriever": {"topK": 2, "scoreThreshold": 0.5},
                             "engine": {"kvCacheDtype": "int8", "maxSeqLen": 4096}}, fmt)
    env.setenv("APP_CONFIG_FILE", path)
    env.setenv("APP_RETRIEVER_TOPK", "3")
    env.setenv("APP_ENGINE_KVCACHEDTYPE", "int4")
    tcfg, jcfg = tconfig.get_config(), jconfig.get_config()
    assert _fields_equal(tcfg, jcfg) == {}
    assert (tcfg.vector_store.name, tcfg.vector_store.persist_dir) == ("faiss", "/data/vs")
    assert (tcfg.retriever.top_k, tcfg.retriever.score_threshold) == (3, 0.5)
    assert (tcfg.engine.kv_cache_dtype, tcfg.engine.max_seq_len) == ("int4", 4096)
    assert tconfig.get_config() is tcfg  # cached once per process


def test_an_empty_variable_overrides_the_file_as_in_jax(env, tmp_path):
    path = _write(tmp_path, {"llm": {"serverUrl": "http://llm:8000"}}, "json")
    env.setenv("APP_CONFIG_FILE", path)
    env.setenv("APP_LLM_SERVERURL", "")
    assert tconfig.get_config().llm.server_url == jconfig.get_config().llm.server_url == ""


@pytest.mark.parametrize("content", [None, "", "- a list\n- not a mapping\n", "{not: [json"],
                         ids=["missing", "empty", "list", "broken"])
def test_a_missing_or_unusable_file_leaves_the_environment_alone(env, tmp_path, content):
    path = tmp_path / "app.yaml"
    if content is not None:
        path.write_text(content)
    env.setenv("APP_CONFIG_FILE", str(path))
    env.setenv("APP_RETRIEVER_TOPK", "7")
    tcfg, jcfg = tconfig.get_config(), jconfig.get_config()
    assert _fields_equal(tcfg, jcfg) == {}
    assert tcfg.retriever.top_k == 7
    assert tconfig.AppConfig.from_file(str(path)) is None


def test_yaml_booleans_and_numbers_coerce_as_in_jax(env, tmp_path):
    path = tmp_path / "app.yaml"
    path.write_text("resilience:\n  enable: off\n  retryJitter: 1\n"
                    "engine:\n  maxBatchSize: 4.0\n  streamTimeoutS: 30\n"
                    "vectorStore:\n  name: 5\n  nlist: '32'\n")
    tcfg, jcfg = tconfig.AppConfig.from_file(str(path)), jconfig.AppConfig.from_file(str(path))
    assert _fields_equal(tcfg, jcfg) == {}
    assert tcfg.resilience.enable == "False" and tcfg.engine.max_batch_size == 4
    assert tcfg.vector_store.name == "5" and tcfg.vector_store.nlist == 32


@pytest.mark.parametrize("section,field,value", [
    ("engine", "tensor_parallelism", 0),
    ("engine", "chunked_prefill", "off"),
    ("engine", "paged_kernel", "off"),
])
def test_an_unserved_value_in_a_file_is_refused_as_from_the_environment(env, tmp_path, section,
                                                                         field, value):
    camel = config_wizard.to_camel_case
    path = _write(tmp_path, {camel(section): {camel(field): value}}, "json")
    with pytest.raises(ValueError) as from_file:
        tconfig.AppConfig.from_file(path)
    env.setenv(config_wizard.env_name(section, field), str(value))
    with pytest.raises(ValueError) as from_env:
        tconfig.AppConfig.from_env()
    assert str(from_file.value) == str(from_env.value)
    assert config_wizard.env_name(section, field) in str(from_file.value)
    # through get_config and a file only
    env.delenv(config_wizard.env_name(section, field))
    env.setenv("APP_CONFIG_FILE", path)
    with pytest.raises(ValueError) as got:
        tconfig.get_config()
    assert str(got.value) == str(from_file.value)


@pytest.mark.parametrize("section,field,value,message", [
    ("retriever", "nr_url", "http://nr:8000", None),
    ("text_splitter", "model_name", "bert-base", None),
    ("retriever", "nr_url", "nr:8000",
     "retriever.nr_url must carry a scheme (http://host:port), got 'nr:8000'"),
    ("text_splitter", "model_name", "  ", "text_splitter.model_name must not be empty"),
])
def test_a_checked_and_ignored_field_in_a_file_is_jax_s(env, tmp_path, section, field, value,
                                                         message):
    """``retriever.nr_url`` and ``text_splitter.model_name``: a file's value
    is read as the environment's and JAX's, and the startup check accepts
    or refuses it as JAX's does, with JAX's message."""
    from generativeaiexamples_tpu.config import validate as jvalidate
    from generativeaiexamples_tpu_torch import config_validate

    camel = config_wizard.to_camel_case
    path = _write(tmp_path, {camel(section): {camel(field): value}}, "json")
    tcfg, jcfg = tconfig.AppConfig.from_file(path), jconfig.AppConfig.from_file(path)
    assert getattr(getattr(tcfg, section), field) == getattr(getattr(jcfg, section), field) == value
    env.setenv(config_wizard.env_name(section, field), value)
    assert getattr(getattr(tconfig.AppConfig.from_env(), section), field) == value
    outcomes = []
    for validate, cfg in ((jvalidate.validate_config, jcfg),
                          (config_validate.validate_config, tcfg)):
        try:
            validate(cfg)
            outcomes.append(None)
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes == [message, message]


@pytest.mark.parametrize("section,field,value", [
    ("engine", "checkpoint_path", "/ckpt"),
    ("engine", "spec_draft_checkpoint_path", "/draft"),
    ("embeddings", "checkpoint_path", "/w"),
    ("ranking", "checkpoint_path", "/r"),
])
def test_a_checkpoint_path_in_a_file_is_served_as_from_the_environment(env, tmp_path, section,
                                                                       field, value):
    """The checkpoint paths (refused until ROADMAP queue 1 item 10): a
    file's value is the environment's and JAX's; the build reads it."""
    camel = config_wizard.to_camel_case
    path = _write(tmp_path, {camel(section): {camel(field): value}}, "json")
    from_file = tconfig.AppConfig.from_file(path)
    env.setenv(config_wizard.env_name(section, field), value)
    assert getattr(getattr(from_file, section), field) == value
    assert getattr(getattr(tconfig.AppConfig.from_env(), section), field) == value
    assert getattr(getattr(jconfig.AppConfig.from_file(path), section), field) == value


def test_an_xla_only_value_in_a_file_is_read_and_ignored(tmp_path):
    path = _write(tmp_path, {"engine": {"servingLayout": "scan", "warmupPromptLengths": "64"}},
                  "json")
    assert tconfig.AppConfig.from_file(path).engine == tconfig.EngineConfig()


def test_the_vector_store_url_of_compose_is_jax_s(env):
    """deploy/compose/compose.env's two vector-store variables."""
    env.setenv("APP_VECTORSTORE_NAME", "milvus")
    env.setenv("APP_VECTORSTORE_URL", "http://milvus:19530")
    assert dataclasses.asdict(tconfig.get_config().vector_store) == \
        dataclasses.asdict(jconfig.get_config().vector_store)
    assert tconfig.get_config().vector_store.url == "http://milvus:19530"


def test_env_names_are_jax_s_for_every_field():
    jax_names = {path: name for name, path, _ in jconfig.AppConfig.envvars()}
    port_names = {}
    for section, fields in tconfig.AppConfig.sections():
        for name, _typ, _default, _reason in fields:
            path = (config_wizard.to_camel_case(section), config_wizard.to_camel_case(name))
            port_names[path] = config_wizard.env_name(section, name)
            if section == "engine":
                assert port_names[path] == tconfig.EngineConfig.env_name(name)
            else:
                assert port_names[path] == tconfig._env_name(section, name)
    assert port_names == jax_names  # the port knows every JAX field, served or not


def _rows(printer_cls):
    out = []
    printer_cls.print_help(out.append)
    text = "".join(out)
    return text, {line.split("  (env: ")[0].strip(): line.strip()
                  for line in text.splitlines() if "  (env: " in line}


def test_print_help_rows_of_shared_fields_are_jax_s():
    ttext, trows = _rows(tconfig.AppConfig)
    jtext, jrows = _rows(jconfig.AppConfig)
    assert ttext.startswith("---\nConfiguration (env overrides file):\n---\n")
    assert set(trows) == set(jrows)
    differ = {path for path in trows if trows[path] != jrows[path]}
    # the black box's directory defaults under TMPDIR in the port (JAX: /tmp)
    assert differ <= {"blackbox.dir"}
    assert ("not served by the port: the port always reads a paged pool through its kernel "
            "on the card") in ttext


def test_the_chain_server_prints_the_schema(capsys, monkeypatch):
    import sys

    from generativeaiexamples_tpu_torch.server import __main__ as server_main

    monkeypatch.setattr(sys, "argv", ["server", "--help-config"])
    server_main.main()
    assert "vectorStore.url  (env: APP_VECTORSTORE_URL)" in capsys.readouterr().out


def test_the_process_engine_and_the_factories_read_the_file(env, tmp_path):
    """The chain server's engine (``get_engine`` with no config), embedder
    and reranker are built from the file too, as JAX's read
    ``get_config()``."""
    from generativeaiexamples_tpu_torch.engine import embedder as tembedder
    from generativeaiexamples_tpu_torch.engine import llm_engine
    from generativeaiexamples_tpu_torch.engine import reranker as treranker

    path = _write(tmp_path, {"engine": {"modelConfigName": "debug", "maxSeqLen": 128,
                                        "prefillChunk": 16, "pageSize": 16, "dtype": "float32",
                                        "maxBatchSize": 2},
                             "embeddings": {"modelEngine": "hash", "dimensions": 24},
                             "ranking": {"modelEngine": "overlap"}}, "yaml")
    env.setenv("APP_CONFIG_FILE", path)
    env.setenv("APP_ENGINE_MAXBATCHSIZE", "3")
    saved = llm_engine._ENGINE
    caches = dict(tembedder._EMBEDDER_CACHE), dict(treranker._RERANKER_CACHE)
    llm_engine._ENGINE = None
    try:
        engine = llm_engine.get_engine(device="cpu")
        cfg = engine.engine_config
        assert (cfg.model_config_name, cfg.max_seq_len, cfg.max_batch_size) == ("debug", 128, 3)
        assert tembedder.create_embedder().dimensions == 24
        assert type(treranker.create_reranker()).__name__ == "OverlapReranker"
    finally:
        if llm_engine._ENGINE is not None and llm_engine._ENGINE is not saved:
            llm_engine._ENGINE.shutdown()
        llm_engine._ENGINE = saved
        for cache, before in zip((tembedder._EMBEDDER_CACHE, treranker._RERANKER_CACHE), caches):
            cache.clear()
            cache.update(before)


@pytest.mark.parametrize("value,message", [
    (2, None),
    (1, None),
    (0, "engine.pipeline_parallelism must be >= 1, got 0"),
])
def test_pipeline_parallelism_in_a_file_is_read_and_checked_as_jax_s(env, tmp_path, value, message):
    """Refused until ROADMAP queue 1 item 9b: ``engine.pipelineParallelism``
    from a file is read as the environment's and JAX's, and the startup
    check accepts or refuses it as JAX's does, with JAX's message."""
    from generativeaiexamples_tpu.config import validate as jvalidate
    from generativeaiexamples_tpu_torch import config_validate

    path = _write(tmp_path, {"engine": {"pipelineParallelism": value}}, "json")
    tcfg, jcfg = tconfig.AppConfig.from_file(path), jconfig.AppConfig.from_file(path)
    assert tcfg.engine.pipeline_parallelism == jcfg.engine.pipeline_parallelism == value
    env.setenv("APP_ENGINE_PIPELINEPARALLELISM", str(value))
    assert tconfig.AppConfig.from_env().engine.pipeline_parallelism == value
    outcomes = []
    for validate, cfg in ((jvalidate.validate_config, jcfg),
                          (config_validate.validate_config, tcfg)):
        try:
            validate(cfg)
            outcomes.append(None)
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is None) if message is None else (message in outcomes[1])
