"""Assistant-style wrapper over the port's multimodal RAG chain
(counterpart of the JAX repository's experimental/multimodal_assistant/):
directory ingestion and a Q&A loop."""
from generativeaiexamples_tpu_torch.experimental.multimodal_assistant.app import (
    MultimodalAssistant,
)

__all__ = ["MultimodalAssistant"]
