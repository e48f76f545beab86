"""LangChain connectors for the port's engine.

Counterpart of the root ``integrations/langchain_tpu.py``, with its class
names, so that a user changes only the import. ``ChatTPU`` and
``TPUEmbeddings`` present LangChain's method surface over the port's
in-process llama engine and encoder on the card, or over any
OpenAI-compatible endpoint:

    chat = ChatTPU()                      # in-process engine
    chat = ChatTPU(base_url="http://host:8000/v1", model="llama3-8b")
    chat.invoke([("user", "hi")])         # -> text
    for chunk in chat.stream(msgs): ...

    emb = TPUEmbeddings()
    emb.embed_documents(["a", "b"]); emb.embed_query("q")

LangChain itself is optional: without ``langchain_core`` the classes are
standalone duck-types of the same methods; with it,
``ChatTPU(...).as_langchain()`` and ``TPUEmbeddings(...).as_langchain()``
return real ``BaseChatModel`` and ``Embeddings`` instances for LCEL
pipelines. ``stream`` records an ``llm.chat`` span with an
``llm.new_token`` event a chunk, through the port's utils/tracing.py.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple


def _leaf_span(name: str, attributes: dict):
    """(span, finish) pair safe to hold open across generator suspensions.

    ``tracer.span()`` pushes onto a thread-local stack — held open inside
    a suspended generator it mis-parents the caller's next spans and the
    eventual pop removes whatever is on top. A leaf span is parented to
    the stack top at creation but never pushed, so abandoning the
    generator early can't corrupt the stack; finish() enqueues it.
    """
    from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

    tracer = get_tracer()
    cur = tracer.current_span()
    span = tracer.start_span(
        name, remote_ctx=cur.context if cur is not None else None, attributes=attributes
    )
    return span, lambda: tracer.finish_span(span)


def _normalize_messages(messages: Any) -> List[Tuple[str, str]]:
    """Accept LangChain message objects, (role, content) tuples, dicts,
    or a bare string prompt."""
    if isinstance(messages, str):
        return [("user", messages)]
    out: List[Tuple[str, str]] = []
    for m in messages:
        if isinstance(m, tuple):
            out.append((m[0], str(m[1])))
        elif isinstance(m, dict):
            out.append((m.get("role", "user"), str(m.get("content", ""))))
        else:  # langchain BaseMessage duck-type: .type / .content
            role = {"human": "user", "ai": "assistant"}.get(
                getattr(m, "type", "user"), getattr(m, "type", "user")
            )
            out.append((role, str(getattr(m, "content", m))))
    return out


class ChatTPU:
    """Chat model over the in-process engine or a remote endpoint.

    ``base_url=None`` uses the process engine on the card (no HTTP hop); a
    URL selects the OpenAI-compatible client; ``backend`` gives one
    outright (engine/llm_backend.resolve_backend).
    """

    def __init__(
        self,
        base_url: Optional[str] = None,
        model: str = "local",
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        backend: Any = None,
    ):
        from generativeaiexamples_tpu_torch.engine.llm_backend import resolve_backend

        self._backend = resolve_backend(base_url, model, backend)
        self.temperature = temperature
        self.top_p = top_p
        self.max_tokens = max_tokens

    def _params(self, kwargs) -> dict:
        return {
            "temperature": kwargs.get("temperature", self.temperature),
            "top_p": kwargs.get("top_p", self.top_p),
            "max_tokens": kwargs.get("max_tokens", self.max_tokens),
            "stop": tuple(kwargs.get("stop") or ()),
        }

    def stream(self, messages: Any, **kwargs) -> Iterable[str]:
        """Stream completion chunks, wrapped in an ``llm.chat`` span with
        an ``llm.new_token`` event a chunk, so that framework users get
        spans without the chain runtime."""
        params = self._params(kwargs)
        norm = _normalize_messages(messages)
        span, finish = _leaf_span(
            "llm.chat",
            {
                "llm.temperature": params["temperature"],
                "llm.top_p": params["top_p"],
                "llm.max_tokens": params["max_tokens"],
                "llm.messages": len(norm),
            },
        )
        chunks = 0
        chars = 0
        try:
            for delta in self._backend.stream_chat(norm, **params):
                chunks += 1
                chars += len(delta)
                span.add_event("llm.new_token", {"size": len(delta)})
                yield delta
        except GeneratorExit:
            raise  # early consumer stop is normal, not a span error
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            span.set_attribute("llm.chunks", chunks)
            span.set_attribute("llm.completion_chars", chars)
            finish()

    def invoke(self, messages: Any, **kwargs) -> str:
        return "".join(self.stream(messages, **kwargs))

    # pre-LCEL LangChain entry points, kept for drop-in compatibility
    def predict(self, text: str, **kwargs) -> str:
        return self.invoke(text, **kwargs)

    def as_langchain(self):
        """Return a real langchain_core BaseChatModel (requires
        langchain-core installed). Implements _stream so LCEL `.stream()`
        yields per-token chunks — without it langchain falls back to
        _call and the whole answer arrives as one chunk, defeating the
        stack's SSE streaming contract."""
        from langchain_core.language_models.chat_models import SimpleChatModel
        from langchain_core.messages import AIMessageChunk
        from langchain_core.outputs import ChatGenerationChunk

        outer = self

        class _ChatTPU(SimpleChatModel):
            @property
            def _llm_type(self) -> str:
                return "chat-tpu"

            def _call(self, messages, stop=None, run_manager=None, **kw) -> str:
                return outer.invoke(messages, stop=stop, **kw)

            def _stream(self, messages, stop=None, run_manager=None, **kw):
                for delta in outer.stream(messages, stop=stop, **kw):
                    chunk = ChatGenerationChunk(
                        message=AIMessageChunk(content=delta)
                    )
                    if run_manager:
                        run_manager.on_llm_new_token(delta, chunk=chunk)
                    yield chunk

        return _ChatTPU()


class TPUEmbeddings:
    """Embeddings over the in-process encoder (the chain runtime's
    embedder) or a remote ``/v1/embeddings`` endpoint."""

    def __init__(self, base_url: Optional[str] = None, model: str = "local",
                 dimensions: int = 1024, embedder: Any = None):
        if embedder is not None:
            self._embedder = embedder
        elif base_url:
            from generativeaiexamples_tpu_torch.engine.embedder import RemoteEmbedder

            self._embedder = RemoteEmbedder(base_url, model, dimensions)
        else:
            from generativeaiexamples_tpu_torch.chains import runtime

            self._embedder = runtime.get_embedder()

    def embed_documents(self, texts: Sequence[str]) -> List[List[float]]:
        import numpy as np

        from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

        with get_tracer().span("embedder.embed_documents", {"count": len(texts)}):
            return np.asarray(self._embedder.embed_documents(list(texts))).tolist()

    def embed_query(self, text: str) -> List[float]:
        import numpy as np

        from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

        with get_tracer().span("embedder.embed_query"):
            return np.asarray(self._embedder.embed_query(text)).tolist()

    def as_langchain(self):
        """Return a real langchain_core Embeddings (requires
        langchain-core installed)."""
        from langchain_core.embeddings import Embeddings

        outer = self

        class _TPUEmbeddings(Embeddings):
            def embed_documents(self, texts: List[str]) -> List[List[float]]:
                return outer.embed_documents(texts)

            def embed_query(self, text: str) -> List[float]:
                return outer.embed_query(text)

        return _TPUEmbeddings()
