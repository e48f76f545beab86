"""The contract every example chain implements (a copy of the JAX
package's generativeaiexamples_tpu/chains/base.py)."""
from abc import ABC, abstractmethod
from typing import Any, Generator, List


class BaseExample(ABC):
    """Base class for RAG example chains served by the chain server."""

    @abstractmethod
    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        """Answer a prompt without retrieval; yields response chunks."""

    @abstractmethod
    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        """Answer a prompt grounded in the knowledge base; yields response chunks."""

    @abstractmethod
    def ingest_docs(self, data_dir: str, filename: str) -> None:
        """Ingest a document into the vector store."""

    # Optional methods the server probes for:
    #   document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]
    #   get_documents(self) -> List[str]
    #   delete_documents(self, filenames: List[str]) -> bool
