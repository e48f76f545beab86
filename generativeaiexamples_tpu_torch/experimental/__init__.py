"""Experimental applications built on the port (counterpart of the JAX
repository's experimental/): streaming-transcript RAG, the O-RAN spec
chatbot and the multimodal assistant."""
