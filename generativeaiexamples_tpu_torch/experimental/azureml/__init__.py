"""A client for LLM endpoints speaking Triton's HTTP protocol (counterpart
of the JAX repository's experimental/azureml/): ``TritonHTTPClient`` on
``urllib`` with bearer-token auth, and ``TritonLLMBackend``, an LLM backend
the port's chains and apps can use in place of the in-process engine."""
from generativeaiexamples_tpu_torch.experimental.azureml.triton_client import (
    TritonHTTPClient,
    TritonLLMBackend,
)

__all__ = ["TritonHTTPClient", "TritonLLMBackend"]
