"""Experimental applications built on the port (counterpart of the JAX
repository's experimental/): streaming-transcript RAG, the O-RAN spec
chatbot, the multimodal assistant, CVE triage with a tool-using agent
(``cve_analysis``), streaming document ingestion (``streaming_ingest``)
and a Triton-protocol LLM client (``azureml``)."""
