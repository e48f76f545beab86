"""The chain server's startup validation (generativeaiexamples_tpu_torch/
config_validate.py, called by server/api.py ``make_server``) against the
JAX package's config/validate.py, on the same ``APP_*`` environment:

- the 16 values of ROADMAP queue 3 fault 1 (JAX refused all 16; the port
  started on 14 of them before the repair), then one bad value for each
  other check the port copies: ``make_server`` and JAX's
  ``validate_config`` both refuse, with equal messages;
- the resilience section's checks and the fault spec's install refuse
  as the JAX server's ``create_app`` does, and the retrieval tier needs
  the in-process store;
- both accept the defaults, a structured-data deployment that names its
  own ``llm.model_name_pandas_ai``, and the deployments of
  ``chip_smoke.py`` (phase 7's ``RAG_ENV`` and phase 8's chains over a
  remote engine).
"""
import os
import tempfile

import pytest

import chip_smoke
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.config.validate import validate_config as jvalidate
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains.echo import EchoChain
from generativeaiexamples_tpu_torch.server.api import make_server

# ROADMAP queue 3 fault 1: the 14 values the port started on, then the two
# it refused with messages of its own (now JAX's)
FAULT_1 = [
    ("APP_LLM_MODELENGINE", "bogus"),
    ("APP_EMBEDDINGS_MODELENGINE", "bogus"),
    ("APP_RANKING_MODELENGINE", "bogus"),
    ("APP_RETRIEVER_TOPK", "0"),
    ("APP_RETRIEVER_SCORETHRESHOLD", "1.5"),
    ("APP_RETRIEVER_NRPIPELINE", "bogus"),
    ("APP_RETRIEVER_CONTEXTTOKENCAP", "-1"),
    ("APP_TEXTSPLITTER_CHUNKSIZE", "0"),
    ("APP_TEXTSPLITTER_CHUNKOVERLAP", "600"),
    ("APP_RANKING_FETCHFACTOR", "0"),
    ("APP_VECTORSTORE_NLIST", "0"),
    ("APP_EMBEDDINGS_DIMENSIONS", "0"),
    ("APP_ENGINE_MAXSEQLEN", "0"),
    ("APP_PROMPTS_CHATTEMPLATE", " "),
    ("APP_ENGINE_DTYPE", "bogus"),
    ("APP_ENGINE_QUANTIZATION", "bogus"),
]
# one bad value for each other check of config_validate
OTHER_CHECKS = [
    ("APP_VECTORSTORE_NAME", " "),
    ("APP_VECTORSTORE_NPROBE", "0"),
    ("APP_VECTORSTORE_PERSISTDIR", " "),
    ("APP_LLM_MODELNAME", " "),
    ("APP_LLM_MODELNAMEPANDASAI", ""),
    ("APP_LLM_MODELNAMEPANDASAI", " "),
    ("APP_LLM_MODELENGINE", "remote"),
    ("APP_TEXTSPLITTER_CHUNKOVERLAP", "-1"),
    ("APP_EMBEDDINGS_MODELNAME", " "),
    ("APP_EMBEDDINGS_QUERYCACHESIZE", "-1"),
    ("APP_EMBEDDINGS_MODELENGINE", "openai"),
    ("APP_RETRIEVER_SCORETHRESHOLD", "-0.1"),
    ("APP_RETRIEVER_ANNMODE", "hnsw"),
    ("APP_RETRIEVER_ANNCAPACITY", "-1"),
    ("APP_RETRIEVER_ANNMAXBATCH", "0"),
    ("APP_RANKING_MODELNAME", " "),
    ("APP_RANKING_MODELENGINE", "remote"),
    ("APP_PROMPTS_RAGTEMPLATE", " "),
    ("APP_PROMPTS_MULTITURNRAGTEMPLATE", " "),
    ("APP_ENGINE_KVCACHEDTYPE", "fp8"),
    ("APP_ENGINE_MAXBATCHSIZE", "0"),
    ("APP_ENGINE_MODELCONFIGNAME", " "),
    ("APP_ENGINE_PREFILLWAVETOKENS", "0"),
    ("APP_ENGINE_DECODERUNAHEAD", "0"),
    ("APP_ENGINE_DECODEBLOCK", "0"),
    ("APP_ENGINE_STREAMTIMEOUTS", "0"),
    ("APP_ENGINE_MAXQUEUEDREQUESTS", "3"),
    ("APP_ENGINE_WATCHDOGSTALLS", "-1"),
    # the retrieval tier, the scheduler and the drain
    ("APP_RETRIEVER_BACKEND", "bogus"),
    ("APP_RETRIEVER_TIERQUEUEDEPTH", "-1"),
    ("APP_RETRIEVER_TIERWINDOWMS", "-1"),
    ("APP_ENGINE_SCHEDULERPOLICY", "bogus"),
    ("APP_ENGINE_HANDOFFQUEUEDEPTH", "-1"),
    ("APP_ENGINE_DRAINTIMEOUTS", "0"),
    ("APP_ENGINE_SNAPSHOTSPOOLDIR", ""),
    ("APP_ENGINE_SNAPSHOTSPOOLMAX", "0"),
    # speculative decoding
    ("APP_ENGINE_SPECPIPELINEENABLE", "bogus"),
    ("APP_ENGINE_SPECPROPOSER", "oracle"),
    ("APP_ENGINE_SPECDRAFTMINACCEPTANCE", "1.0"),
    ("APP_ENGINE_SPECADAPTIVEK", "maybe"),
    ("APP_ENGINE_SPECADAPTIVEKMIN", "0"),
    ("APP_ENGINE_SPECADAPTIVEKTHRESHOLD", "0.0"),
]
# one bad value for each check of the resilience section (utils/resilience.py)
RESILIENCE_CHECKS = [
    ("APP_RESILIENCE_ENABLE", "maybe"),
    ("APP_RESILIENCE_RETRYMAXATTEMPTS", "0"),
    ("APP_RESILIENCE_RETRYBASEDELAYMS", "-1"),
    ("APP_RESILIENCE_RETRYMAXDELAYMS", "-1"),
    ("APP_RESILIENCE_RETRYJITTER", "1.5"),
    ("APP_RESILIENCE_BREAKERFAILURETHRESHOLD", "0"),
    ("APP_RESILIENCE_BREAKERRECOVERYS", "0"),
    ("APP_RESILIENCE_FAULTS", "nocolon"),
    ("APP_RESILIENCE_FAULTS", "retrieval.search:bogus@1"),
    ("APP_RESILIENCE_FAULTS", "retrieval.search:error@0"),
]


@pytest.fixture
def env(monkeypatch):
    """A clean APP_* environment, read afresh by both packages."""
    for key in list(os.environ):
        if key.startswith("APP_") or key == "EXAMPLE_NAME":
            monkeypatch.delenv(key, raising=False)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()
    yield monkeypatch
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


@pytest.fixture(autouse=True)
def _observability_state():
    """``make_server`` configures the port's flight recorder, SLO tracker,
    black box and dispatch timeline from the config: put them back to
    their module defaults after each test."""
    yield
    from generativeaiexamples_tpu_torch.engine import dispatch_timeline
    from generativeaiexamples_tpu_torch.utils import blackbox, flight_recorder, slo

    flight_recorder.reset()
    slo.reset()
    blackbox.reset()
    dispatch_timeline.configure(enable=True, capacity=4096)


def _port_starts():
    server = make_server("127.0.0.1", 0, EchoChain)
    server.server_close()


@pytest.mark.parametrize("name,value", FAULT_1 + OTHER_CHECKS,
                         ids=[f"{n}={v!r}" for n, v in FAULT_1 + OTHER_CHECKS])
def test_make_server_refuses_what_jax_refuses(env, name, value):
    env.setenv(name, value)
    with pytest.raises(ValueError) as want:
        jvalidate(jget_config())
    with pytest.raises(ValueError) as got:
        _port_starts()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,value", RESILIENCE_CHECKS,
                         ids=[f"{n}={v!r}" for n, v in RESILIENCE_CHECKS])
def test_make_server_refuses_bad_resilience_values_like_jax(env, name, value):
    """The resilience section's checks and the fault spec's install: the
    JAX server's ``create_app`` and the port's ``make_server`` refuse with
    equal messages."""
    from generativeaiexamples_tpu.chains.echo import EchoChain as JEcho
    from generativeaiexamples_tpu.server import api as japi
    from generativeaiexamples_tpu.utils import faults as jfaults
    from generativeaiexamples_tpu_torch.utils import faults as tfaults

    env.setenv(name, value)
    try:
        with pytest.raises(ValueError) as want:
            japi.create_app(JEcho)
        with pytest.raises(ValueError) as got:
            _port_starts()
    finally:
        jfaults.reset()
        tfaults.reset()
    assert str(got.value) == str(want.value)


def test_tier_needs_the_in_process_store_like_jax(env):
    env.setenv("APP_RETRIEVER_BACKEND", "tier")
    env.setenv("APP_VECTORSTORE_NAME", "milvus")
    with pytest.raises(ValueError) as want:
        jvalidate(jget_config())
    with pytest.raises(ValueError) as got:
        _port_starts()
    assert str(got.value) == str(want.value)
    assert "retriever.backend=tier requires" in str(got.value)


@pytest.mark.parametrize("deployment", ["defaults", "pandas_model", "rag", "chains_remote"])
def test_both_accept_the_defaults_and_the_smoke_deployments(env, deployment):
    values = {
        "defaults": {},
        # served, as in JAX: a deployment may name the structured-data model
        "pandas_model": {"EXAMPLE_NAME": "structured_data",
                         "APP_LLM_MODELNAMEPANDASAI": "meta-llama/Meta-Llama-3-70B-Instruct"},
        "rag": chip_smoke.RAG_ENV,
        "chains_remote": dict(chip_smoke.RAG_ENV, **chip_smoke.REMOTE_LLM_ENV,
                              APP_LLM_SERVERURL="http://127.0.0.1:9"),
    }[deployment]
    for key, value in values.items():
        env.setenv(key, value)
    jvalidate(jget_config())
    _port_starts()


# --------------------------------------------------------------------- #
# The observability, blackbox and slo sections

OBSERVABILITY_VALUES = {
    "APP_OBSERVABILITY_FLIGHTRECORDERENABLE": "off",
    "APP_OBSERVABILITY_FLIGHTRECORDERCAPACITY": "12",
    "APP_OBSERVABILITY_SLOWREQUESTTTFTMS": "50",
    "APP_OBSERVABILITY_SLOWREQUESTTOTALMS": "2.5",
    "APP_OBSERVABILITY_SLOWCAPTUREPATH": "/tmp/slowcap.jsonl",
    "APP_OBSERVABILITY_DISPATCHTIMELINEENABLE": "off",
    "APP_OBSERVABILITY_DISPATCHTIMELINECAPACITY": "100.7",
    "APP_BLACKBOX_ENABLE": "off",
    "APP_BLACKBOX_DIR": "/tmp/bb",
    "APP_BLACKBOX_MAXBUNDLES": "3",
    "APP_BLACKBOX_MININTERVALS": "0",
    "APP_BLACKBOX_SLOBREACHSTREAK": "0",
    "APP_BLACKBOX_SHEDSPIKE": "3",
    "APP_BLACKBOX_PAGEBACKPRESSURESTORM": "1",
    "APP_BLACKBOX_REPLICADEATHSTORM": "9",
    "APP_SLO_ENABLE": "off",
    "APP_SLO_WINDOWS": "60",
    "APP_SLO_TTFTP95MS": "1500.5",
    "APP_SLO_INTERTOKENP95MS": "0",
    "APP_SLO_SHEDRATEMAX": "0.25",
    "APP_SLO_DEGRADEDRATEMAX": "1",
    "APP_SLO_ROUTERPROXYOVERHEADP95MS": "10",
    "APP_SLO_ROUTERFAILOVERRATEMAX": "0.5",
}
# one bad value for each check of the three sections
OBSERVABILITY_CHECKS = [
    ("APP_OBSERVABILITY_FLIGHTRECORDERENABLE", "maybe"),
    ("APP_OBSERVABILITY_FLIGHTRECORDERCAPACITY", "0"),
    ("APP_OBSERVABILITY_SLOWREQUESTTTFTMS", "-1"),
    ("APP_OBSERVABILITY_SLOWREQUESTTOTALMS", "-0.5"),
    ("APP_OBSERVABILITY_SLOWCAPTUREPATH", "/tmp"),
    ("APP_OBSERVABILITY_DISPATCHTIMELINEENABLE", "sometimes"),
    ("APP_OBSERVABILITY_DISPATCHTIMELINECAPACITY", "63"),
    ("APP_BLACKBOX_ENABLE", "yes"),
    ("APP_BLACKBOX_DIR", " "),
    ("APP_BLACKBOX_MAXBUNDLES", "0"),
    ("APP_BLACKBOX_MININTERVALS", "-1"),
    ("APP_BLACKBOX_SLOBREACHSTREAK", "-1"),
    ("APP_BLACKBOX_SHEDSPIKE", "-1"),
    ("APP_BLACKBOX_PAGEBACKPRESSURESTORM", "-1"),
    ("APP_BLACKBOX_REPLICADEATHSTORM", "-1"),
    ("APP_SLO_ENABLE", "1"),
    ("APP_SLO_WINDOWS", "0"),
    ("APP_SLO_TTFTP95MS", "-1"),
    ("APP_SLO_INTERTOKENP95MS", "-1"),
    ("APP_SLO_SHEDRATEMAX", "1.5"),
    ("APP_SLO_DEGRADEDRATEMAX", "-0.5"),
    ("APP_SLO_ROUTERPROXYOVERHEADP95MS", "-1"),
    ("APP_SLO_ROUTERFAILOVERRATEMAX", "2"),
]
SECTIONS = {"observability": "ObservabilityConfig", "blackbox": "BlackboxConfig",
            "slo": "SLOConfig"}


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_observability_sections_have_jax_s_fields_and_defaults(env, section):
    import dataclasses

    from generativeaiexamples_tpu.config import schema

    jax_cls = getattr(schema, SECTIONS[section])
    port_cls = getattr(tconfig, SECTIONS[section])
    assert [f.name for f in dataclasses.fields(port_cls)] == [
        f.name for f in dataclasses.fields(jax_cls)]
    want = dataclasses.asdict(getattr(jget_config(), section))
    if section == "blackbox":
        # the port keeps its bundles under the temporary directory (TMPDIR)
        assert want["dir"] == "/tmp/genai_blackbox"
        want["dir"] = os.path.join(tempfile.gettempdir(), "genai_blackbox")
    assert dataclasses.asdict(port_cls()) == want


def test_observability_variables_parse_as_jax_parses_them(env):
    import dataclasses

    for key, value in OBSERVABILITY_VALUES.items():
        env.setenv(key, value)
    jax, port = jget_config(), tconfig.get_config()
    for section in SECTIONS:
        assert dataclasses.asdict(getattr(port, section)) == dataclasses.asdict(
            getattr(jax, section)), section
    assert port.observability.dispatch_timeline_capacity == 100  # "100.7", as JAX reads it
    _port_starts()


@pytest.mark.parametrize("name,value", OBSERVABILITY_CHECKS,
                         ids=[f"{n}={v!r}" for n, v in OBSERVABILITY_CHECKS])
def test_make_server_refuses_bad_observability_values_like_jax(env, name, value):
    """JAX's ``create_app`` and the port's ``make_server`` refuse with
    equal messages."""
    from generativeaiexamples_tpu.chains.echo import EchoChain as JEcho
    from generativeaiexamples_tpu.server import api as japi

    env.setenv(name, value)
    with pytest.raises(ValueError) as want:
        japi.create_app(JEcho)
    with pytest.raises(ValueError) as got:
        _port_starts()
    assert str(got.value) == str(want.value)


def test_a_malformed_number_is_refused_by_both(env):
    env.setenv("APP_OBSERVABILITY_FLIGHTRECORDERCAPACITY", "many")
    with pytest.raises(ValueError):
        jget_config()
    with pytest.raises(ValueError, match="FLIGHTRECORDERCAPACITY='many' is not a valid int"):
        tconfig.get_config()


def test_a_default_server_keeps_its_files_under_tmpdir(env, tmp_path):
    """A server built from the default config arms the black box; a
    breaker that opens writes its bundle under the temporary directory
    (TMPDIR), where the profile directory and the JSONL spans default too."""
    from generativeaiexamples_tpu_torch.utils import blackbox, profiling, resilience, tracing

    tmp = tmp_path / "tmp"
    tmp.mkdir()
    for key in ("PROFILE_LOG_DIR", "TRACE_JSONL_PATH"):
        env.delenv(key, raising=False)
    env.setenv("TMPDIR", str(tmp))
    env.setattr(tempfile, "tempdir", None)  # gettempdir() reads TMPDIR afresh
    _port_starts()
    assert blackbox.enabled()
    resilience.CircuitBreaker("llm_remote", failure_threshold=1).record_failure()
    blackbox.drain()
    bundles = blackbox.list_bundles()
    assert [b["trigger"] for b in bundles] == ["breaker_open"]
    assert os.path.dirname(bundles[0]["path"]) == str(tmp / "genai_blackbox")
    assert profiling.default_log_dir() == str(tmp / "genai_torch_profiles")
    env.setenv("TRACE_EXPORTER", "jsonl")
    assert tracing._exporter_from_env("t").path == str(
        tmp / "generativeaiexamples_tpu_torch_traces.jsonl")
