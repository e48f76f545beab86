"""The single-file RAG chain (``simple_rag``): the port's copy of the JAX
package's generativeaiexamples_tpu/chains/simple_rag.py. Its own
collection ``simple_rag``, chunks of 2000 characters overlapping by 200
(``RecursiveCharacterTextSplitter``), and the ``PROMPT`` below as the
system message. A failed retrieval degrades to an LLM-only answer led by
a ``DegradedWarning``; ``document_search`` lets its errors through, as the
JAX chain does."""
from __future__ import annotations

from typing import Any, Dict, Generator, List

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.engine.llm_engine import EngineOverloaded
from generativeaiexamples_tpu_torch.retrieval.splitter import RecursiveCharacterTextSplitter
from generativeaiexamples_tpu_torch.retrieval.store import Chunk
from generativeaiexamples_tpu_torch.utils.resilience import DeadlineExceeded, resilience_enabled

COLLECTION = "simple_rag"

PROMPT = (
    "You are a helpful AI assistant named Envie. You will reply to questions only based"
    " on the context that you are provided. If something is out of context, you will"
    " refrain from replying and politely decline to respond to the user."
)


class SimpleRAG(BaseExample):
    def ingest_docs(self, filepath: str, filename: str) -> None:
        from generativeaiexamples_tpu_torch.retrieval.loaders import load_document

        text = load_document(filepath)
        splitter = RecursiveCharacterTextSplitter(chunk_size=2000, chunk_overlap=200)
        chunks = [Chunk(text=t, source=filename) for t in splitter.split_text(text)]
        runtime.index_chunks(chunks, COLLECTION)

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        messages = [("system", PROMPT), ("user", query)]
        return runtime.get_llm().stream_chat(
            messages, prefix_hint="simple_rag:chat", **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        try:
            hits = runtime.retrieve(query, collection=COLLECTION)
        except (DeadlineExceeded, EngineOverloaded):
            raise  # the server's 504 and 429
        except Exception as exc:  # noqa: BLE001
            if resilience_enabled():
                return runtime.degraded_answer(
                    "simple_rag", self.llm_chain, query, chat_history, exc, **kwargs)
            raise
        context = runtime.cap_context([h.chunk.text for h in hits])
        messages = [("system", PROMPT), ("user", f"Context: {context}\n\nQuestion: {query}")]
        return runtime.get_llm().stream_chat(
            messages, prefix_hint=f"simple_rag:{COLLECTION}", **runtime.llm_settings(kwargs))

    def document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]:
        hits = runtime.retrieve(content, top_k=num_docs, collection=COLLECTION)
        return [{"source": h.chunk.source, "content": h.chunk.text, "score": h.score}
                for h in hits]

    def get_documents(self) -> List[str]:
        return runtime.get_vector_store(COLLECTION).sources()

    def delete_documents(self, filenames: List[str]) -> bool:
        return runtime.delete_documents(filenames, COLLECTION)
