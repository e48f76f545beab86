"""The example-chain registry: ``EXAMPLE_NAME`` names the chain a
deployment serves, as in the JAX package's
generativeaiexamples_tpu/chains/registry.py, with the same names;
``register_example`` adds an out-of-tree chain. Modules are imported when
their name is resolved, so a chain with heavy imports (pandas, PIL) costs
nothing to the deployments that serve another."""
from __future__ import annotations

import importlib
import logging
import os
from typing import Dict, Type

from generativeaiexamples_tpu_torch.chains.base import BaseExample

logger = logging.getLogger(__name__)

_PKG = "generativeaiexamples_tpu_torch.chains"
_REGISTRY: Dict[str, str] = {
    "developer_rag": f"{_PKG}.developer_rag:QAChatbot",
    "nvidia_api_catalog": f"{_PKG}.api_catalog:APICatalogChatbot",
    "api_catalog": f"{_PKG}.api_catalog:APICatalogChatbot",
    "multi_turn_rag": f"{_PKG}.multi_turn:MultiTurnChatbot",
    "multi_turn": f"{_PKG}.multi_turn:MultiTurnChatbot",
    "query_decomposition_rag": f"{_PKG}.query_decomposition:QueryDecompositionChatbot",
    "query_decomposition": f"{_PKG}.query_decomposition:QueryDecompositionChatbot",
    "structured_data_rag": f"{_PKG}.structured_data:CSVChatbot",
    "structured_data": f"{_PKG}.structured_data:CSVChatbot",
    "multimodal_rag": f"{_PKG}.multimodal:MultimodalRAG",
    "multimodal": f"{_PKG}.multimodal:MultimodalRAG",
    "simple_rag": f"{_PKG}.simple_rag:SimpleRAG",
    "echo": f"{_PKG}.echo:EchoChain",
}

DEFAULT_EXAMPLE = "developer_rag"


def register_example(name: str, target: str) -> None:
    """Register an out-of-tree chain as ``module.path:ClassName``."""
    _REGISTRY[name] = target


def available_examples() -> Dict[str, str]:
    return dict(_REGISTRY)


def resolve_example(name: str | None = None) -> Type[BaseExample]:
    """The example class of this deployment: ``name``, else
    ``EXAMPLE_NAME``, else ``developer_rag``."""
    name = name or os.environ.get("EXAMPLE_NAME", DEFAULT_EXAMPLE)
    if name not in _REGISTRY:
        raise NotImplementedError(f"Unknown example {name!r}. Available: {sorted(_REGISTRY)}")
    modname, _, clsname = _REGISTRY[name].partition(":")
    cls = getattr(importlib.import_module(modname), clsname)
    required = {"ingest_docs", "llm_chain", "rag_chain"}
    if not required.issubset(set(dir(cls))):
        raise ValueError(f"Class {clsname} does not implement {sorted(required)}")
    logger.info("Resolved example %s -> %s", name, _REGISTRY[name])
    return cls
