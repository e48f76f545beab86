"""Assistant-style wrapper over the port's multimodal RAG chain.

Counterpart of the JAX repository's experimental/multimodal_assistant/
app.py: ingest a folder (PDF and PPTX through the multimodal parser, any
other file through the plain-text loaders into the same collection), then
answer questions, headless:

    python -m generativeaiexamples_tpu_torch.experimental.multimodal_assistant.app \\
        --docs specs/ --ask "what does section 3 say about timing?"

Its embedder, store and LLM are the runtime's, on the card; with no card
it raises unless ``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Generator, List

from generativeaiexamples_tpu_torch.chains.multimodal import MultimodalRAG


class MultimodalAssistant:
    def __init__(self):
        self.chain = MultimodalRAG()

    def ingest_directory(self, docs_dir: str) -> List[str]:
        """Ingest every supported file under docs_dir; returns filenames.

        PDF and PPTX go through the multimodal parser; anything else
        through the plain-text loaders into the same collection.
        """
        ingested = []
        for root, _, files in os.walk(docs_dir):
            for fname in sorted(files):
                path = os.path.join(root, fname)
                try:
                    if fname.endswith((".pdf", ".pptx")):
                        self.chain.ingest_docs(path, fname)
                    else:
                        self._ingest_text(path, fname)
                    ingested.append(fname)
                except Exception as exc:  # noqa: BLE001 - skip unreadable or unsupported files
                    print(f"  skipping {fname}: {exc}", file=sys.stderr)
        return ingested

    def _ingest_text(self, path: str, filename: str) -> None:
        from generativeaiexamples_tpu_torch.chains import runtime
        from generativeaiexamples_tpu_torch.chains.multimodal import COLLECTION
        from generativeaiexamples_tpu_torch.retrieval.loaders import load_document
        from generativeaiexamples_tpu_torch.retrieval.store import Chunk

        text = load_document(path)
        pieces = runtime.get_splitter().split_text(text)
        if not pieces:
            raise ValueError(f"No text extracted from {filename}")
        embedder = runtime.get_embedder()
        runtime.get_vector_store(COLLECTION).add(
            [Chunk(text=p, source=filename, metadata={"filename": filename}) for p in pieces],
            embedder.embed_documents(pieces),
        )

    def ask(self, question: str, use_knowledge_base: bool = True) -> Generator[str, None, None]:
        if use_knowledge_base:
            yield from self.chain.rag_chain(question, [])
        else:
            yield from self.chain.llm_chain(question, [])

    def documents(self) -> List[str]:
        return self.chain.get_documents()


def main(argv=None) -> int:
    from generativeaiexamples_tpu_torch.chains import runtime

    parser = argparse.ArgumentParser(description="Multimodal assistant")
    parser.add_argument("--docs", required=True, help="directory of PDFs/PPTX/text")
    parser.add_argument("--ask", action="append", default=[], help="question (repeatable)")
    parser.add_argument("--no-kb", action="store_true", help="answer without retrieval")
    parser.add_argument("--device", default=None,
                        help="device of the embedder, the store and the LLM (default: the card)")
    args = parser.parse_args(argv)
    if args.device is not None:
        runtime.set_device(args.device)
    runtime.check_device("the multimodal assistant")

    assistant = MultimodalAssistant()
    ingested = assistant.ingest_directory(args.docs)
    print(f"ingested {len(ingested)} documents", file=sys.stderr)

    questions = args.ask
    if not questions and sys.stdin.isatty():
        print("Enter questions (ctrl-d to quit):", file=sys.stderr)
        questions = [line.strip() for line in sys.stdin if line.strip()]

    for question in questions:
        print(f"\nQ: {question}")
        print("A: ", end="")
        for token in assistant.ask(question, use_knowledge_base=not args.no_kb):
            print(token, end="", flush=True)
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
