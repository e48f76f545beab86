"""The port's example chains, one for each name of the JAX package's
registry (``available_examples()``), the registry itself and the runtime
they share (``runtime.py``)."""
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.registry import (
    available_examples,
    register_example,
    resolve_example,
)

__all__ = ["BaseExample", "resolve_example", "register_example", "available_examples"]
