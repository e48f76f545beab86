"""The configuration file and the schema's help, as the JAX package's
config/wizard.py has them.

A field's wire name is its camelCase name (``vector_store`` ->
``vectorStore``), and its environment name is ``APP_`` followed by each
camelCase path component upper-cased, joined by ``_``
(``vector_store.url`` -> ``APP_VECTORSTORE_URL``). A configuration file is
JSON, or YAML where it is not JSON, with the wire names as nested keys
(the snake_case field names are accepted too); the environment wins over
the file.

The port reads its configuration from the environment
(``config.AppConfig.from_env``), so a file is read by turning each of its
values into the environment entry that would set the same field
(:func:`file_environ`): a value from a file then passes the same parse and
the same checks as the same value from the environment, and a refusal
names the same variable.

Nothing here imports PyYAML until a file is not JSON.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

ENV_BASE = "APP"

# the JAX schema's help text of each section (config/schema.py AppConfig)
SECTION_HELP = {
    "vector_store": "The configuration of the vector db connection.",
    "llm": "The configuration for the server hosting the Large Language Models.",
    "text_splitter": "The configuration for text splitter.",
    "embeddings": "The configuration of embedding model.",
    "retriever": "The configuration of the retriever pipeline.",
    "ranking": "The configuration of the reranking model.",
    "prompts": "Prompt templates for chat and rag.",
    "engine": "The in-process TPU inference engine.",
    "resilience": "Deadlines, admission control, retry/circuit breaking and fault injection.",
    "batching": "Cross-request micro-batching for the retrieval side-models (embedder + reranker).",
    "observability": "Per-request flight recorder and slow-request capture.",
    "blackbox": "Anomaly black box: incident-triggered debug-bundle capture.",
    "slo": "Service-level objectives evaluated over sliding windows (genai_slo_* gauges + "
           "GET /internal/slo).",
    "router": "Multi-replica routing tier: placement, tenant fairness, health/drain, failover.",
}

# A section as the file and the help see it: its name, and each field's
# (name, type, default, why the port refuses another value or None)
Field = Tuple[str, type, Any, Optional[str]]
Section = Tuple[str, Iterable[Field]]


def to_camel_case(name: str) -> str:
    """``vector_store`` -> ``vectorStore``."""
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def env_name(*path: str) -> str:
    """The environment name of a field path (snake_case names):
    ``env_name("vector_store", "url")`` is ``APP_VECTORSTORE_URL``."""
    return "_".join([ENV_BASE] + [to_camel_case(p).upper() for p in path])


def read_json_or_yaml(raw: str) -> Optional[Dict[str, Any]]:
    """Parse a config document, JSON first, then YAML; None when it is
    neither or not a mapping."""
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        pass
    import yaml

    try:
        loaded = yaml.safe_load(raw)
        return loaded if isinstance(loaded, dict) else None
    except yaml.YAMLError:
        return None


def _lookup(data: Mapping[str, Any], name: str):
    """The wire name's entry, else the snake_case name's (JAX's order);
    ``(False, None)`` when neither is there."""
    for key in (to_camel_case(name), name):
        if key in data:
            return True, data[key]
    return False, None


def _env_value(value: Any, typ: type) -> str:
    """The environment string that sets a field of type ``typ`` to what
    JAX's wizard makes of the file value ``value``: a string field takes
    ``str(value)``, a number field the value as JSON (a string as it is)."""
    if isinstance(value, str):
        return value
    if typ is str:
        return str(value)
    return json.dumps(value)


def file_environ(sections: Iterable[Section], data: Mapping[str, Any]) -> Dict[str, str]:
    """The ``APP_*`` entries that set what the file's ``data`` sets, for
    every field of ``sections`` it holds; keys the schema does not know
    are ignored, as JAX's wizard ignores them."""
    if not isinstance(data, dict):
        raise RuntimeError("Configuration data is not a dictionary.")
    out: Dict[str, str] = {}
    for section, fields in sections:
        found, sub = _lookup(data, section)
        if not found or not isinstance(sub, dict):
            continue
        for name, typ, _default, _reason in fields:
            found, value = _lookup(sub, name)
            if found:
                out[env_name(section, name)] = _env_value(value, typ)
    return out


def section_fields(cls, unserved: Mapping[str, Tuple[Any, Optional[str]]]) -> list:
    """A config dataclass's fields as :data:`Field` rows, then the JAX
    fields it does not serve (``unserved``: name -> (JAX default, reason
    or None))."""
    hints = typing.get_type_hints(cls)
    rows = []
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default is dataclasses.MISSING else f.default
        rows.append((f.name, hints.get(f.name, type(default)), default, None))
    for name, (default, reason) in unserved.items():
        rows.append((name, type(default), default,
                     reason or "exists only for XLA's compiles: read and ignored"))
    return rows


def print_help(sections: Iterable[Section], help_printer: Callable[[str], Any]) -> None:
    """The schema with env names, types and defaults, in the JAX wizard's
    row format; a field the port does not serve says why under its row."""
    help_printer("---\nConfiguration (env overrides file):\n---\n")
    for section, fields in sections:
        jsection = to_camel_case(section)
        help_printer(f"\n[{jsection}] — {SECTION_HELP.get(section, '')}\n")
        for name, typ, default, reason in fields:
            help_printer(
                f"  {jsection}.{to_camel_case(name)}  (env: {env_name(section, name)})"
                f"  [{getattr(typ, '__name__', typ)}] = {default!r}\n"
            )
            if reason:
                help_printer(f"      not served by the port: {reason}\n")
