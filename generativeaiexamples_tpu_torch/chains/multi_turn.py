"""The multi-turn conversational RAG chain (``multi_turn``,
``multi_turn_rag``): the port's copy of the JAX package's
generativeaiexamples_tpu/chains/multi_turn.py.

Conversation memory is a second collection, ``conv_store``: each turn
retrieves document context from ``default`` and past exchanges from
``conv_store``, and a finished turn is written back as "User previously
responded with …" / "Agent previously responded with …" through
``runtime.index_chunks``, so both retrieval legs see it. The prompt is
``prompts.multi_turn_rag_template`` with ``{input}``, ``{history}`` and
``{context}`` filled, plus "User Query: " and the query, sent as one user
message. A degraded turn writes no memory.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Any, Dict, Generator, List

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG
from generativeaiexamples_tpu_torch.config import get_config
from generativeaiexamples_tpu_torch.engine.llm_engine import EngineOverloaded
from generativeaiexamples_tpu_torch.retrieval.store import Chunk
from generativeaiexamples_tpu_torch.utils.resilience import DeadlineExceeded, resilience_enabled

logger = logging.getLogger(__name__)

DOC_COLLECTION = "default"
CONV_COLLECTION = "conv_store"


class MultiTurnChatbot(BaseExample):
    def save_memory_and_get_output(self, d: Dict[str, str], store=None) -> str:
        """Write the exchange ``d`` (``input``, ``output``) to conversation
        memory through ``runtime.index_chunks``, or into ``store`` (with
        its embeddings) when one is given; returns the output."""
        texts = [
            f"User previously responded with {d.get('input')}",
            f"Agent previously responded with {d.get('output')}",
        ]
        chunks = [Chunk(text=t, source="conversation") for t in texts]
        if store is not None:
            store.add(chunks, runtime.get_embedder().embed_documents(texts))
        else:
            runtime.index_chunks(chunks, CONV_COLLECTION)
        return d.get("output", "")

    def ingest_docs(self, filepath: str, filename: str) -> None:
        if not filename.endswith((".txt", ".pdf", ".md")):
            raise ValueError(f"{filename} is not a valid Text, PDF or Markdown file")
        try:
            runtime.ingest_file(filepath, filename, collection=DOC_COLLECTION)
        except Exception as exc:
            logger.error("Failed to ingest document due to exception %s", exc)
            raise ValueError(
                "Failed to upload document. Please upload an unstructured text document."
            ) from exc

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        config = get_config()
        messages = [("system", config.prompts.chat_template), ("user", query)]
        return runtime.get_llm(config).stream_chat(
            messages, prefix_hint="multi_turn:chat", **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        """Retrieval and the engine's submit run at the call (this returns
        a generator, it is not one), so the server's 429 and 504 come
        before any byte of the answer; a failed retrieval degrades to an
        LLM-only answer."""
        config = get_config()
        try:
            doc_hits = runtime.retrieve(query, collection=DOC_COLLECTION, config=config)
            conv_hits = runtime.retrieve(query, collection=CONV_COLLECTION, config=config)
        except (DeadlineExceeded, EngineOverloaded):
            raise  # the server's 504 and 429
        except Exception as exc:  # noqa: BLE001
            if resilience_enabled(config):
                return runtime.degraded_answer(
                    "multi_turn", self.llm_chain, query, chat_history, exc, **kwargs)
            logger.warning("Retrieval failed: %s", exc)
            return iter([NO_CONTEXT_MSG])
        if not doc_hits and not conv_hits:
            logger.warning("Retrieval failed to get any relevant context")
            return iter([NO_CONTEXT_MSG])

        context = runtime.cap_context([h.chunk.text for h in doc_hits], config=config)
        history = runtime.cap_context([h.chunk.text for h in conv_hits], config=config)
        prompt = (config.prompts.multi_turn_rag_template.format(
            input=query, history=history, context=context) + "User Query: " + query)
        # one hint a conversation, keyed off its first exchange: the
        # engine's prefix cache keeps its entry warm between turns
        hist = runtime.history_to_messages(chat_history)
        convo = (hashlib.sha1(hist[0][1].encode("utf-8", "ignore")).hexdigest()[:12]
                 if hist else "first-turn")
        stream = runtime.get_llm(config).stream_chat(
            [("user", prompt)], prefix_hint=f"multi_turn:{convo}", **runtime.llm_settings(kwargs))

        def gen():
            resp = ""
            try:
                for chunk in stream:
                    yield chunk
                    resp += chunk
            finally:
                # a consumer that stops early aborts the engine request now
                close = getattr(stream, "close", None)
                if close is not None:
                    close()
            self.save_memory_and_get_output({"input": query, "output": resp})

        return gen()

    def document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]:
        hits = runtime.retrieve(content, top_k=num_docs, collection=DOC_COLLECTION)
        return [{"source": h.chunk.source, "content": h.chunk.text, "score": h.score}
                for h in hits]

    def get_documents(self) -> List[str]:
        return runtime.get_vector_store(DOC_COLLECTION).sources()

    def delete_documents(self, filenames: List[str]) -> bool:
        return runtime.delete_documents(filenames, DOC_COLLECTION)
