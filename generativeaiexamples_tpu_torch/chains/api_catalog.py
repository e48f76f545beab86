"""The API-catalog QA chain (``api_catalog``, ``nvidia_api_catalog``): the
port's copy of the JAX package's
generativeaiexamples_tpu/chains/api_catalog.py. The shape of
``developer_rag`` with the LangChain chain's quirks kept: no chat history
in ``rag_chain``, a retry without the score threshold when the store has
no thresholded search (``NotImplementedError``), and any failure of
``rag_chain`` answering ``NO_DOCS_MSG``.

With ``llm.server_url`` set and ``llm.model_engine`` ``remote`` (or
``openai``, ``nvidia-ai-endpoints``), ``runtime.get_llm`` answers through
``RemoteLLMBackend``: the split topology, the chain server in one process
and the engine server (``engine/server.py``) in another."""
from __future__ import annotations

import logging
from typing import Any, Dict, Generator, List

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG, NO_DOCS_MSG
from generativeaiexamples_tpu_torch.config import get_config

logger = logging.getLogger(__name__)

COLLECTION = "default"


class APICatalogChatbot(BaseExample):
    """QA chain in the reference's LangChain idiom."""

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
        return runtime.get_llm(config).stream_chat(messages, **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        config = get_config()
        try:
            try:
                hits = runtime.retrieve(query, collection=COLLECTION, config=config)
            except NotImplementedError:
                hits = runtime.retrieve(query, score_threshold=0.0, collection=COLLECTION,
                                        config=config)
            if not hits:
                logger.warning("Retrieval failed to get any relevant context")
                return iter([NO_CONTEXT_MSG])
            context = "".join(h.chunk.text + "\n\n" for h in hits)
            augmented = "Context: " + context + "\n\nQuestion: " + query + "\n"
            messages = [("system", config.prompts.rag_template), ("user", augmented)]
            return runtime.get_llm(config).stream_chat(messages, **runtime.llm_settings(kwargs))
        except Exception as exc:  # noqa: BLE001
            logger.warning("Failed to generate response due to exception %s", exc)
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
