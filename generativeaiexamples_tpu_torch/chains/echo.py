"""A trivial chain for tests and smoke deployments (a copy of the JAX
package's generativeaiexamples_tpu/chains/echo.py): it streams the query
back word by word and keeps documents in memory."""
from __future__ import annotations

from typing import Any, Dict, Generator, List

from generativeaiexamples_tpu_torch.chains.base import BaseExample


class EchoChain(BaseExample):
    """Streams the query back word by word; stores docs in memory."""

    documents: Dict[str, str] = {}

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        for word in (query or "").split(" "):
            yield word + " "

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        context = " ".join(self.documents.values())
        yield f"context:{len(context)} "
        for word in (query or "").split(" "):
            yield word + " "

    def ingest_docs(self, data_dir: str, filename: str) -> None:
        with open(data_dir, "r", encoding="utf-8", errors="replace") as fh:
            self.documents[filename] = fh.read()

    def document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]:
        return [{"content": text[:200], "source": name, "score": 1.0}
                for name, text in list(self.documents.items())[:num_docs]]

    def get_documents(self) -> List[str]:
        return list(self.documents)

    def delete_documents(self, filenames: List[str]) -> bool:
        for name in filenames:
            self.documents.pop(name, None)
        return True
