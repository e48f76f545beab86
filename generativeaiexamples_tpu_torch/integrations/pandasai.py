"""PandasAI LLM adapter for the port's engine.

Counterpart of the root ``integrations/pandasai_tpu.py``, with its class
name: lets PandasAI agents generate pandas code through the in-process
engine or any OpenAI-compatible endpoint. PandasAI is optional: ``TPULLM``
implements the adapter protocol (``call(instruction, context) -> str``,
``type``) standalone, and the port's CSV chain
(chains/structured_data.py) does not need PandasAI at all.
"""
from __future__ import annotations

from typing import Any, Optional


class TPULLM:
    """PandasAI-protocol LLM over the in-process engine or a remote
    endpoint: temperature, top_p and max-token knobs plus a server URL for
    split deployments."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        model: str = "local",
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        backend: Any = None,
    ):
        from generativeaiexamples_tpu_torch.engine.llm_backend import resolve_backend

        self._backend = resolve_backend(base_url, model, backend)
        self.temperature = temperature
        self.top_p = top_p
        self.max_tokens = max_tokens

    @property
    def type(self) -> str:
        return "tpu-llm"

    def call(self, instruction: Any, context: Any = None, suffix: str = "") -> str:
        """PandasAI entry point: render the instruction (PandasAI passes a
        prompt object with to_string()) and complete it."""
        prompt = (
            instruction.to_string()
            if hasattr(instruction, "to_string")
            else str(instruction)
        ) + suffix
        return self._backend.complete(
            [("user", prompt)],
            temperature=self.temperature,
            top_p=self.top_p,
            max_tokens=self.max_tokens,
        )
