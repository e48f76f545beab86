"""The canonical QA chain (``developer_rag``): the port's copy of the JAX
package's generativeaiexamples_tpu/chains/developer_rag.py. Ingest is
load, split (510 words, 200 overlap), embed and insert; an answer is
retrieve (top-k above the score threshold), the context capped at 1500
words, the prompt, and the engine's streamed generation. The fallback
messages are the JAX package's, verbatim."""
from __future__ import annotations

import logging
from typing import Any, Dict, Generator, List

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.config import get_config
from generativeaiexamples_tpu_torch.engine.llm_engine import EngineOverloaded
from generativeaiexamples_tpu_torch.utils.resilience import DeadlineExceeded, resilience_enabled

logger = logging.getLogger(__name__)

NO_CONTEXT_MSG = (
    "No response generated from LLM, make sure your query is relavent to the ingested document."
)
NO_DOCS_MSG = (
    "No response generated from LLM, make sure you have ingested document from the Knowledge Base Tab."
)

COLLECTION = "default"


class QAChatbot(BaseExample):
    """Canonical QA over ingested documents."""

    def ingest_docs(self, filepath: str, filename: str) -> None:
        try:
            runtime.ingest_file(filepath, filename, collection=COLLECTION)
        except Exception as exc:
            logger.error("Failed to ingest %s: %s", filename, exc)
            raise ValueError(
                "Failed to upload document. Please upload an unstructured text document."
            ) from exc

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        config = get_config()
        messages = ([("system", config.prompts.chat_template)]
                    + runtime.history_to_messages(chat_history) + [("user", query)])
        return runtime.get_llm(config).stream_chat(
            messages, prefix_hint="developer_rag:chat", **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        """A failed retrieval degrades to an LLM-only answer led by a
        DegradedWarning (``resilience.enable=off``: the canned NO_DOCS_MSG);
        an empty one answers NO_CONTEXT_MSG."""
        config = get_config()
        try:
            hits = runtime.retrieve(query, collection=COLLECTION, config=config)
        except (DeadlineExceeded, EngineOverloaded):
            raise  # the server's 504 and 429
        except Exception as exc:  # noqa: BLE001
            if resilience_enabled(config):
                return runtime.degraded_answer(
                    "developer_rag", self.llm_chain, query, chat_history, exc, **kwargs)
            logger.warning("Failed to generate response due to exception %s", exc)
            logger.warning("No response generated from LLM, make sure you've ingested document.")
            return iter([NO_DOCS_MSG])
        try:
            if not hits:
                logger.warning("Retrieval failed to get any relevant context")
                return iter([NO_CONTEXT_MSG])
            context = runtime.cap_context([h.chunk.text for h in hits], config=config)
            augmented = "Context: " + context + "\n\nQuestion: " + query + "\n"
            messages = [("system", config.prompts.rag_template), ("user", augmented)]
            return runtime.get_llm(config).stream_chat(
                messages, prefix_hint=f"developer_rag:{COLLECTION}",
                **runtime.llm_settings(kwargs))
        except (DeadlineExceeded, EngineOverloaded):
            raise
        except Exception as exc:  # noqa: BLE001
            logger.warning("Failed to generate response due to exception %s", exc)
        logger.warning("No response generated from LLM, make sure you've ingested document.")
        return iter([NO_DOCS_MSG])

    def document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]:
        try:
            hits = runtime.retrieve(content, top_k=num_docs, collection=COLLECTION)
            return [{"source": h.chunk.source, "content": h.chunk.text, "score": h.score}
                    for h in hits]
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from document_search: %s", exc)
            return []

    def get_documents(self) -> List[str]:
        return runtime.get_vector_store(COLLECTION).sources()

    def delete_documents(self, filenames: List[str]) -> bool:
        return runtime.delete_documents(filenames, COLLECTION)
