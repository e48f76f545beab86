"""LlamaIndex connectors for the port's engine.

Counterpart of the root ``integrations/llamaindex_tpu.py``, with its class
names: the LlamaIndex-protocol face of integrations/langchain.py.

    llm = TPULlamaIndexLLM()                    # in-process engine
    llm.complete("prompt").text
    for r in llm.stream_complete("prompt"): r.delta
    llm.chat([("user", "hi")]).message.content

    emb = TPULlamaIndexEmbedding()
    emb.get_query_embedding("q"); emb.get_text_embedding_batch(texts)

    ret = TPULlamaIndexRetriever(collection="default")
    nodes = ret.retrieve("query")               # NodeWithScore duck-types

LlamaIndex itself is optional: without ``llama_index`` the classes are
standalone duck-types of the same methods, returning small response
objects with LlamaIndex's field names (``.text``, ``.delta``,
``.message.content``, ``.node.text``/``.score``); with it,
``as_llamaindex()`` returns each as the real base class (``CustomLLM``,
``BaseEmbedding``, ``BaseRetriever``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Sequence

from generativeaiexamples_tpu_torch.integrations.langchain import ChatTPU, TPUEmbeddings


@dataclasses.dataclass
class CompletionResponse:
    """Duck-type of llama_index.core.llms.CompletionResponse."""

    text: str
    delta: str = ""


@dataclasses.dataclass
class _Message:
    role: str
    content: str


@dataclasses.dataclass
class ChatResponse:
    """Duck-type of llama_index.core.llms.ChatResponse."""

    message: _Message
    delta: str = ""


@dataclasses.dataclass
class _Node:
    """Duck-type of llama_index TextNode: .text + .metadata + get_content()."""

    text: str
    metadata: dict

    def get_content(self) -> str:
        return self.text


@dataclasses.dataclass
class NodeWithScore:
    """Duck-type of llama_index.core.schema.NodeWithScore."""

    node: _Node
    score: float

    def get_content(self) -> str:
        return self.node.text


class TPULlamaIndexLLM:
    """LlamaIndex-protocol LLM over the in-process engine or a remote
    OpenAI-compatible endpoint. Delegates streaming (and its ``llm.chat``
    span) to langchain.ChatTPU: one seam, two protocol faces."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        model: str = "local",
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        backend: Any = None,
    ):
        self._chat = ChatTPU(
            base_url=base_url,
            model=model,
            temperature=temperature,
            top_p=top_p,
            max_tokens=max_tokens,
            backend=backend,
        )
        self.max_tokens = max_tokens

    @property
    def metadata(self) -> dict:
        return {
            "model_name": "tpu-llm",
            "is_chat_model": True,
            "num_output": self.max_tokens,
        }

    # --- LlamaIndex LLM protocol -------------------------------------
    def complete(self, prompt: str, **kwargs) -> CompletionResponse:
        return CompletionResponse(text=self._chat.invoke(str(prompt), **kwargs))

    def stream_complete(self, prompt: str, **kwargs) -> Iterable[CompletionResponse]:
        text = ""
        for delta in self._chat.stream(str(prompt), **kwargs):
            text += delta
            yield CompletionResponse(text=text, delta=delta)

    def chat(self, messages: Any, **kwargs) -> ChatResponse:
        text = self._chat.invoke(messages, **kwargs)
        return ChatResponse(message=_Message(role="assistant", content=text))

    def stream_chat(self, messages: Any, **kwargs) -> Iterable[ChatResponse]:
        text = ""
        for delta in self._chat.stream(messages, **kwargs):
            text += delta
            yield ChatResponse(
                message=_Message(role="assistant", content=text), delta=delta
            )

    def as_llamaindex(self):
        """Real llama_index.core CustomLLM (requires llama-index-core)."""
        from llama_index.core.llms import (  # type: ignore[import-not-found]
            CompletionResponse as LICompletionResponse,
            CustomLLM,
            LLMMetadata,
        )
        from llama_index.core.llms.callbacks import llm_completion_callback

        outer = self

        class _TPULLM(CustomLLM):
            @property
            def metadata(self) -> LLMMetadata:
                return LLMMetadata(
                    model_name="tpu-llm",
                    is_chat_model=True,
                    num_output=outer.max_tokens,
                )

            @llm_completion_callback()
            def complete(self, prompt: str, **kw) -> LICompletionResponse:
                return LICompletionResponse(text=outer.complete(prompt, **kw).text)

            @llm_completion_callback()
            def stream_complete(self, prompt: str, **kw):
                for r in outer.stream_complete(prompt, **kw):
                    yield LICompletionResponse(text=r.text, delta=r.delta)

        return _TPULLM()


class TPULlamaIndexEmbedding:
    """LlamaIndex-protocol embedding model. Delegates to
    langchain.TPUEmbeddings (the same embedder and spans)."""

    def __init__(self, base_url: Optional[str] = None, model: str = "local",
                 dimensions: int = 1024, embedder: Any = None):
        self._emb = TPUEmbeddings(
            base_url=base_url, model=model, dimensions=dimensions, embedder=embedder
        )

    def get_text_embedding(self, text: str) -> List[float]:
        return self.get_text_embedding_batch([text])[0]

    def get_text_embedding_batch(self, texts: Sequence[str], **kwargs) -> List[List[float]]:
        return self._emb.embed_documents(list(texts))

    def get_query_embedding(self, query: str) -> List[float]:
        return self._emb.embed_query(query)

    # async variants of the protocol delegate to the sync paths
    async def aget_query_embedding(self, query: str) -> List[float]:
        return self.get_query_embedding(query)

    def as_llamaindex(self):
        """Real llama_index.core BaseEmbedding (requires llama-index-core)."""
        from llama_index.core.embeddings import BaseEmbedding  # type: ignore[import-not-found]

        outer = self

        class _TPUEmbedding(BaseEmbedding):
            def _get_query_embedding(self, query: str) -> List[float]:
                return outer.get_query_embedding(query)

            def _get_text_embedding(self, text: str) -> List[float]:
                return outer.get_text_embedding(text)

            async def _aget_query_embedding(self, query: str) -> List[float]:
                return outer.get_query_embedding(query)

        return _TPUEmbedding()


class TPULlamaIndexRetriever:
    """LlamaIndex-protocol retriever over the chain runtime's retrieval
    pipeline (chains/runtime.retrieve)."""

    def __init__(
        self,
        collection: str = "default",
        top_k: Optional[int] = None,
        score_threshold: Optional[float] = None,
    ):
        self.collection = collection
        self.top_k = top_k
        self.score_threshold = score_threshold

    def retrieve(self, query: str) -> List[NodeWithScore]:
        from generativeaiexamples_tpu_torch.chains import runtime

        hits = runtime.retrieve(
            query,
            top_k=self.top_k,
            score_threshold=self.score_threshold,
            collection=self.collection,
        )
        return [
            NodeWithScore(
                node=_Node(
                    text=h.chunk.text,
                    metadata={"filename": h.chunk.source, **h.chunk.metadata},
                ),
                score=float(h.score),
            )
            for h in hits
        ]

    def as_llamaindex(self):
        """Real llama_index.core BaseRetriever (requires llama-index-core)."""
        from llama_index.core.retrievers import BaseRetriever  # type: ignore[import-not-found]
        from llama_index.core.schema import (
            NodeWithScore as LINodeWithScore,
            QueryBundle,
            TextNode,
        )

        outer = self

        class _TPURetriever(BaseRetriever):
            def _retrieve(self, query_bundle: QueryBundle):
                return [
                    LINodeWithScore(
                        node=TextNode(text=n.node.text, metadata=n.node.metadata),
                        score=n.score,
                    )
                    for n in outer.retrieve(query_bundle.query_str)
                ]

        return _TPURetriever()
