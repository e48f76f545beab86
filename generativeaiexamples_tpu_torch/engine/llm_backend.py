"""The LLM backend seam: the chains' view of "an LLM".

Counterpart of generativeaiexamples_tpu/engine/llm_backend.py:

- ``TorchLLMBackend``: the in-process engine (``get_engine``; on the card
  unless ``device`` says otherwise), the port's ``TPULLMBackend``;
- ``RemoteLLMBackend``: any OpenAI-compatible ``/v1/chat/completions``
  server, streamed over ``urllib``; the connect is retried with backoff
  behind the ``llm_remote`` circuit breaker (``call_with_resilience``), as
  in JAX, and once bytes stream nothing is replayed;
- ``EchoLLMBackend``: streams the last user message back (tests).

``create_llm`` takes the JAX config's ``llm.model_engine`` names: ``tpu``
and ``local`` (the in-process engine), ``openai``,
``nvidia-ai-endpoints`` and ``remote`` (with ``llm.server_url``), ``echo``.
Both model backends call the ``backend.stream`` fault point first.
``stream_chat`` takes ``prefix_hint``, the chain or session a request
belongs to: ``TorchLLMBackend`` hands it to the engine's prefix KV cache
(``SamplingParams.prefix_hint``) and ``RemoteLLMBackend`` drops it, as
the JAX backends do (the OpenAI wire format has no field for it). So it
is with ``spec_decode``, the request's speculative-decoding switch:
``TorchLLMBackend`` passes it to the engine (``SamplingParams.spec_decode``:
``False`` opts the request out of drafting) and ``RemoteLLMBackend`` drops
it, as in JAX.
"""
from __future__ import annotations

import json
import urllib.request
from typing import Generator, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.utils import faults as faults_mod
from generativeaiexamples_tpu_torch.utils import resilience

Messages = Sequence[Tuple[str, str]]  # (role, content)


class LLMBackend:
    def stream_chat(
        self,
        messages: Messages,
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        stop: Sequence[str] = (),
        prefix_hint: Optional[str] = None,
        spec_decode: Optional[bool] = None,
    ) -> Generator[str, None, None]:
        raise NotImplementedError

    def complete(self, messages: Messages, **kwargs) -> str:
        return "".join(self.stream_chat(messages, **kwargs))


class TorchLLMBackend(LLMBackend):
    """The in-process engine: ``engine``, or the process engine built on
    ``device`` (None: the card)."""

    def __init__(self, engine=None, device=None):
        if engine is None:
            from generativeaiexamples_tpu_torch.engine.llm_engine import get_engine

            engine = get_engine(device=device)
        self._engine = engine

    def stream_chat(self, messages, temperature=0.2, top_p=0.7, max_tokens=1024,
                    stop=(), prefix_hint=None, spec_decode=None):
        from generativeaiexamples_tpu_torch.engine.llm_engine import SamplingParams
        from generativeaiexamples_tpu_torch.engine.tokenizer import render_chat_cached

        faults_mod.fault_point("backend.stream")
        params = SamplingParams(temperature=temperature, top_p=top_p, max_tokens=max_tokens,
                                stop=tuple(stop or ()), prefix_hint=prefix_hint,
                                spec_decode=spec_decode)
        # the request's remaining budget (bound to this thread by the
        # server) becomes the stream's timeout; the submit is eager, so a
        # full admission queue raises EngineOverloaded here, before any
        # byte of the answer went out
        deadline = resilience.get_current_deadline()
        timeout = None
        if deadline is not None:
            resilience.raise_if_deadline_expired("backend.stream")
            timeout = max(0.05, deadline.remaining())
        ids = render_chat_cached(self._engine.tokenizer, list(messages))
        return self._engine.stream_text(ids, params, timeout=timeout)


class RemoteLLMBackend(LLMBackend):
    """OpenAI-compatible streaming chat client over ``urllib``."""

    def __init__(self, server_url: str, model_name: str, timeout: float = 600.0):
        from generativeaiexamples_tpu_torch.engine.embedder import normalize_v1_url

        self._url = normalize_v1_url(server_url)
        self._model = model_name
        self._timeout = timeout

    def stream_chat(self, messages, temperature=0.2, top_p=0.7, max_tokens=1024,
                    stop=(), prefix_hint=None, spec_decode=None):
        faults_mod.fault_point("backend.stream")
        payload = {
            "model": self._model,
            "messages": [{"role": r, "content": c} for r, c in messages],
            "temperature": temperature,
            "top_p": top_p,
            "max_tokens": max_tokens,
            "stream": True,
        }
        if stop:
            payload["stop"] = list(stop)
        deadline = resilience.get_current_deadline()
        timeout = self._timeout
        if deadline is not None:
            timeout = max(0.05, min(timeout, deadline.remaining()))
        req = urllib.request.Request(
            f"{self._url}/chat/completions", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        # retry and breaker cover the connect only: once bytes stream, a
        # replay could send answer text twice
        resp = resilience.call_with_resilience(
            "llm_remote", urllib.request.urlopen, req, timeout=timeout,
            retry_on=resilience.URL_ERRORS, retry_filter=resilience.http_error_is_transient,
        )

        def gen():
            with resp:
                for raw in resp:
                    line = raw.decode("utf-8").strip()
                    if not line.startswith("data: "):
                        continue
                    body = line[len("data: "):]
                    if body.strip() == "[DONE]":
                        break
                    delta = json.loads(body)["choices"][0].get("delta", {}).get("content", "")
                    if delta:
                        yield delta

        return gen()


class EchoLLMBackend(LLMBackend):
    """Streams the last user message back word by word (tests)."""

    def stream_chat(self, messages, temperature=0.2, top_p=0.7, max_tokens=1024,
                    stop=(), prefix_hint=None, spec_decode=None):
        last_user = next((c for r, c in reversed(list(messages)) if r == "user"), "")

        def gen():
            for word in last_user.split(" ")[:max_tokens]:
                yield word + " "

        return gen()


def resolve_backend(base_url=None, model: str = "local", backend=None) -> LLMBackend:
    """An explicit backend wins, a URL selects the OpenAI-compatible
    client, otherwise the in-process engine on the card."""
    if backend is not None:
        return backend
    if base_url:
        return RemoteLLMBackend(base_url, model)
    return TorchLLMBackend()


_LLM_CACHE: dict = {}


def create_llm(config=None, device=None, **overrides) -> LLMBackend:
    """The backend ``config.llm`` names (``model_engine``, ``server_url``
    and ``model_name`` may be overridden), built once per (engine,
    server_url, model_name); the in-process engine runs on ``device``
    (None: the card)."""
    from generativeaiexamples_tpu_torch.config import get_config

    config = config or get_config()
    engine_kind = (overrides.get("model_engine") or config.llm.model_engine or "tpu").lower()
    server_url = overrides.get("server_url", config.llm.server_url)
    model_name = overrides.get("model_name", config.llm.model_name)
    key = (engine_kind, server_url, model_name)
    if key in _LLM_CACHE:
        return _LLM_CACHE[key]
    if engine_kind == "echo":
        backend: LLMBackend = EchoLLMBackend()
    elif server_url and engine_kind in ("openai", "nvidia-ai-endpoints", "remote"):
        backend = RemoteLLMBackend(server_url, model_name)
    elif engine_kind in ("tpu", "local"):
        backend = TorchLLMBackend(device=device)
    else:
        raise ValueError(f"Unknown llm model_engine {engine_kind!r}")
    _LLM_CACHE[key] = backend
    return backend
