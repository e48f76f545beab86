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
