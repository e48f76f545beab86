"""5-minute RAG: one file, no external services.

Counterpart of the JAX repository's examples/five_min_rag.py: every
readable file of a directory -> the token splitter (510/200) -> the
``faiss`` store (the C++ index on the host) -> a terminal chat over the
runtime's embedder and LLM engine, both on the card.

    python -m generativeaiexamples_tpu_torch.examples.five_min_rag --docs ./my_docs
    python -m generativeaiexamples_tpu_torch.examples.five_min_rag --docs ./my_docs -q "..."

With no card it raises unless ``--device cpu`` asks for the CPU. With no
checkpoint configured the LLM has random weights (useful only to check the
plumbing); point APP_ENGINE_CHECKPOINTPATH at a Llama-3 safetensors
directory for real answers.
"""
from __future__ import annotations

import argparse
import os
import sys

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.retrieval.loaders import load_document
from generativeaiexamples_tpu_torch.retrieval.splitter import get_text_splitter
from generativeaiexamples_tpu_torch.retrieval.store import Chunk, create_vector_store

PROMPT = (
    "You are a helpful AI assistant. Use the following context to answer "
    "the question. If you don't know the answer, say so.\n\n"
    "Context: {context}\n\nQuestion: {question}"
)


def build_store(docs_dir: str, embedder):
    """Every readable file under docs_dir, split, embedded and stored."""
    splitter = get_text_splitter(chunk_size=510, chunk_overlap=200)
    store = create_vector_store("faiss", dimensions=embedder.dimensions,
                                device=runtime.get_device())
    n_files = 0
    for root, _, files in os.walk(docs_dir):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            try:
                text = load_document(path)
            except Exception as exc:  # noqa: BLE001 - skip unreadable files
                print(f"  skipping {fname}: {exc}", file=sys.stderr)
                continue
            pieces = splitter.split_text(text)
            if not pieces:
                continue
            chunks = [Chunk(text=p, source=fname) for p in pieces]
            store.add(chunks, embedder.embed_documents(pieces))
            n_files += 1
            print(f"  ingested {fname}: {len(pieces)} chunks", file=sys.stderr)
    print(f"Knowledge base ready: {n_files} files, {store.count()} chunks.",
          file=sys.stderr)
    return store


def answer(question: str, store, embedder, llm, top_k: int = 4):
    hits = store.search(embedder.embed_query(question), top_k)
    context = runtime.cap_context([h.chunk.text for h in hits])
    messages = [("user", PROMPT.format(context=context, question=question))]
    for chunk in llm.stream_chat(messages, temperature=0.2, max_tokens=512):
        print(chunk, end="", flush=True)
    print()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="5-minute RAG")
    parser.add_argument("--docs", required=True, help="directory of documents")
    parser.add_argument("-q", "--question", help="one-shot question (else REPL)")
    parser.add_argument("--top-k", type=int, default=4)
    parser.add_argument("--device", default=None,
                        help="device of the embedder and the LLM (default: the card)")
    args = parser.parse_args(argv)
    if args.device is not None:
        runtime.set_device(args.device)
    runtime.check_device("five_min_rag")

    embedder = runtime.get_embedder()
    llm = runtime.get_llm()
    store = build_store(args.docs, embedder)

    if args.question:
        answer(args.question, store, embedder, llm, args.top_k)
        return 0
    print("Ask questions (ctrl-d to exit):", file=sys.stderr)
    try:
        while True:
            question = input("> ").strip()
            if question:
                answer(question, store, embedder, llm, args.top_k)
    except (EOFError, KeyboardInterrupt):
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
