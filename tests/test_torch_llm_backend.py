"""The per-request speculative-decoding switch through the LLM backends
(ROADMAP queue 3 fault 3): the JAX package's ``TPULLMBackend`` passes
``stream_chat(..., spec_decode=...)`` into ``SamplingParams`` and the
port's ``TorchLLMBackend`` must too.

A spec-on engine (prompt lookup, debug preset, the same weights) behind
each backend, the same greedy chat: with ``spec_decode=False`` neither
engine drafts a token for the request; with the default (None, follow the
engine) both draft the same number, and the answers are equal either way.
``RemoteLLMBackend`` drops the field, as JAX's does (the OpenAI wire format
has no field for it). Exact comparisons: no tolerance applies."""
import time

import pytest

MESSAGES = [("user", "abc abc abc abc abc abc abc abc abc abc")]


@pytest.fixture(scope="module")
def engines():
    import jax.numpy as jnp

    from generativeaiexamples_tpu.config import EngineConfig as JaxEngineConfig
    from generativeaiexamples_tpu.engine.llm_engine import LLMEngine as JaxEngine
    from generativeaiexamples_tpu.models import llama as jl
    from generativeaiexamples_tpu_torch.config import EngineConfig
    from generativeaiexamples_tpu_torch.engine.llm_engine import LLMEngine
    from generativeaiexamples_tpu_torch.models.convert import params_from_jax

    common = dict(model_config_name="debug", max_batch_size=2, max_seq_len=128,
                  prefill_chunk=16, dtype="float32", page_size=16, spec_decode_enable="on")
    jax_engine = JaxEngine(JaxEngineConfig(tensor_parallelism=1, serving_layout="layered",
                                           **common))
    weights = jl.init_params_fast(jl.PRESETS["debug"], 0, jnp.float32)
    port = LLMEngine(EngineConfig(**common), device="cpu", params=params_from_jax(weights))
    yield jax_engine, port
    jax_engine.shutdown()
    port.shutdown()


def _drafted_by(engines, spec):
    from generativeaiexamples_tpu.engine.llm_backend import TPULLMBackend
    from generativeaiexamples_tpu_torch.engine.llm_backend import TorchLLMBackend

    jax_engine, port = engines
    out = {}
    for name, backend, drafted in (
        ("jax", TPULLMBackend(engine=jax_engine),
         lambda: jax_engine.metrics["spec_drafted_tokens"]),
        ("port", TorchLLMBackend(engine=port), lambda: port.stats()["spec_drafted_tokens"]),
    ):
        before = drafted()
        text = "".join(backend.stream_chat(MESSAGES, temperature=0.0, max_tokens=24,
                                           spec_decode=spec))
        deadline = time.time() + 30  # the last verify's counters land with its readback
        while time.time() < deadline and drafted() == before and spec is not False:
            time.sleep(0.01)
        out[name] = (drafted() - before, text)
    return out


def test_spec_decode_false_opts_the_request_out_on_both(engines):
    out = _drafted_by(engines, False)
    assert out["port"] == out["jax"]
    assert out["port"][0] == 0


def test_the_default_follows_the_engine_on_both(engines):
    out = _drafted_by(engines, None)
    assert out["port"] == out["jax"]
    assert out["port"][0] > 0


def test_remote_backend_drops_the_field(monkeypatch):
    """The port's remote backend sends the OpenAI body without it."""
    import io
    import json

    from generativeaiexamples_tpu_torch.engine import llm_backend
    from generativeaiexamples_tpu_torch.utils import resilience

    sent = []

    def fake_call(dependency, fn, req, **kwargs):
        sent.append(json.loads(req.data))
        return io.BytesIO(b'data: {"choices": [{"delta": {"content": "x"}}]}\n\ndata: [DONE]\n')

    monkeypatch.setattr(resilience, "call_with_resilience", fake_call)
    backend = llm_backend.RemoteLLMBackend("http://127.0.0.1:9", "m")
    assert "".join(backend.stream_chat(MESSAGES, spec_decode=False)) == "x"
    assert "spec_decode" not in sent[0] and sent[0]["stream"] is True
