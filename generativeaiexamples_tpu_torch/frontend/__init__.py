"""rag-playground frontend.

Counterpart of generativeaiexamples_tpu/frontend/: the two playground
pages (``/content/converse``, ``/content/kb``, byte-equal to JAX's) and
the chain-server REST contract proxied under ``/api/*``, on the standard
library's HTTP server, with a REST :class:`ChatClient` over ``urllib``.
"""
from generativeaiexamples_tpu_torch.frontend.chat_client import ChatClient

__all__ = ["ChatClient"]
