"""The RAG evaluation harness: synthetic QnA, answers through a live chain
server, RAGAS-style metrics and a Likert LLM judge (counterpart of the
JAX repository's tools/evaluation/)."""
