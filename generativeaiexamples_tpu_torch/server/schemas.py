"""Chain-server wire schemas: the JAX package's
generativeaiexamples_tpu/server/schemas.py as dataclasses.

The same fields, defaults and bounds, validated as pydantic's lax mode
validates the parsed JSON body there (numbers from numeric strings, 0 and 1
and "yes"/"off"... as booleans, ...), with pydantic's error types, messages
and order, so the server's 422 body is the JAX server's. ``Message`` runs
``server/sanitize.clean`` (the JAX package's ``bleach.clean(v,
strip=True)``) on role and content, the answer chunks the server builds
included. ``ChainResponse.to_json`` gives pydantic's
``model_dump_json(exclude_none=True)`` bytes: compact, non-ASCII as is,
fields in declaration order.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
from typing import Any, Dict, List, Optional

from generativeaiexamples_tpu_torch.server.sanitize import clean

MAX_CONTENT_LEN = 131072
_ROLES = {"user", "assistant", "system"}
_BOOL_STRINGS = {"0": False, "off": False, "f": False, "false": False, "n": False, "no": False,
                 "1": True, "on": True, "t": True, "true": True, "y": True, "yes": True}
_INT_STRING = re.compile(r"\s*([+-]?[0-9](?:_?[0-9])*)(?:\.0+)?\s*")


class ValidationError(Exception):
    """Field errors in pydantic's shape: dicts of type, loc, msg and,
    where pydantic gives one, ctx."""

    def __init__(self, errors: List[Dict[str, Any]]):
        super().__init__(f"{len(errors)} validation error(s)")
        self.errors = errors


def _err(errors, type_, loc, msg, **ctx) -> None:
    e: Dict[str, Any] = {"type": type_, "loc": loc, "msg": msg}
    if ctx:
        e["ctx"] = ctx
    errors.append(e)


def _num(x) -> str:
    """A bound as pydantic prints it in a message (1.0 as 1)."""
    return str(int(x)) if isinstance(x, float) and x.is_integer() else str(x)


def _bounded(errors, loc, value, ge=None, le=None):
    if le is not None and not value <= le:
        _err(errors, "less_than_equal", loc, f"Input should be less than or equal to {_num(le)}",
             le=le)
    elif ge is not None and not value >= ge:
        _err(errors, "greater_than_equal", loc,
             f"Input should be greater than or equal to {_num(ge)}", ge=ge)
    else:
        return value
    return None


def _as_str(errors, loc, value, max_length: int):
    if not isinstance(value, str):
        _err(errors, "string_type", loc, "Input should be a valid string")
        return None
    if len(value) > max_length:
        _err(errors, "string_too_long", loc, f"String should have at most {max_length} characters",
             max_length=max_length)
        return None
    return value


def _as_bool(errors, loc, value):
    if isinstance(value, bool):
        return value
    if isinstance(value, (int, float)) and value in (0, 1):
        return bool(value)
    if isinstance(value, str) and value.lower() in _BOOL_STRINGS:
        return _BOOL_STRINGS[value.lower()]
    if isinstance(value, (str, int)) or (
            isinstance(value, float) and value.is_integer() and abs(value) < 2.0 ** 63):
        _err(errors, "bool_parsing", loc,
             "Input should be a valid boolean, unable to interpret input")
    else:
        _err(errors, "bool_type", loc, "Input should be a valid boolean")
    return None


def _as_int(errors, loc, value, ge=None, le=None):
    if isinstance(value, bool):
        value = int(value)
    elif isinstance(value, float):
        if not math.isfinite(value):
            _err(errors, "finite_number", loc, "Input should be a finite number")
            return None
        if not value.is_integer():
            _err(errors, "int_from_float", loc,
                 "Input should be a valid integer, got a number with a fractional part")
            return None
        if abs(value) >= 2.0 ** 63:
            _err(errors, "int_parsing_size", loc,
                 "Unable to parse input string as an integer, exceeded maximum size")
            return None
        value = int(value)
    elif isinstance(value, str):
        m = _INT_STRING.fullmatch(value)
        if m is None:
            _err(errors, "int_parsing", loc,
                 "Input should be a valid integer, unable to parse string as an integer")
            return None
        value = int(m.group(1))
    elif not isinstance(value, int):
        _err(errors, "int_type", loc, "Input should be a valid integer")
        return None
    return _bounded(errors, loc, value, ge, le)


def _as_float(errors, loc, value, ge=None, le=None):
    if isinstance(value, (bool, int, float)):
        value = float(value)
    elif isinstance(value, str):
        try:
            if not value.isascii():  # Python's float() reads other digits too
                raise ValueError(value)
            value = float(value)
        except ValueError:
            _err(errors, "float_parsing", loc,
                 "Input should be a valid number, unable to parse string as a number")
            return None
    else:
        _err(errors, "float_type", loc, "Input should be a valid number")
        return None
    return _bounded(errors, loc, value, ge, le)


def _as_list(errors, loc, value, max_length: int, item):
    if not isinstance(value, list):
        _err(errors, "list_type", loc, "Input should be a valid list")
        return None
    out = [item(errors, loc + (k,), v) for k, v in enumerate(value)]
    if len(value) > max_length:
        _err(errors, "too_long", loc,
             f"List should have at most {max_length} items after validation, not {len(value)}",
             field_type="List", max_length=max_length, actual_length=len(value))
        return None
    return out


def _model(errors, loc, value, cls_name: str) -> Optional[dict]:
    if not isinstance(value, dict):
        _err(errors, "model_type", loc,
             f"Input should be a valid dictionary or instance of {cls_name}", class_name=cls_name)
        return None
    return value


def _missing(errors, loc) -> None:
    _err(errors, "missing", loc, "Field required")


@dataclasses.dataclass
class Message:
    """A chat message."""

    role: str = "user"
    content: str = "I am going to Paris, what should I see?"

    @classmethod
    def make(cls, role: str, content: str) -> "Message":
        """A message with the JAX validators applied (sanitized content, a
        lower-cased known role); raises ValueError on another role."""
        role = clean(role)
        if role.lower() not in _ROLES:
            raise ValueError("Role must be one of 'user', 'assistant', or 'system'")
        return cls(role=role.lower(), content=clean(content))

    @classmethod
    def _validate(cls, errors, loc, value) -> Optional["Message"]:
        data = _model(errors, loc, value, "Message")
        if data is None:
            return None
        n = len(errors)
        role = _as_str(errors, loc + ("role",), data.get("role", "user"), 256)
        if role is not None:
            role = clean(role)
            if role.lower() not in _ROLES:
                msg = "Role must be one of 'user', 'assistant', or 'system'"
                _err(errors, "value_error", loc + ("role",), "Value error, " + msg, error=msg)
            role = role.lower()
        content = _as_str(errors, loc + ("content",),
                          data.get("content", cls.content), MAX_CONTENT_LEN)
        if len(errors) > n:
            return None
        return cls(role=role, content=clean(content))

    def to_dict(self) -> Dict[str, Any]:
        return {"role": self.role, "content": self.content}


@dataclasses.dataclass
class Prompt:
    """The /generate request body."""

    messages: List[Message]
    use_knowledge_base: bool
    temperature: float = 0.2
    top_p: float = 0.7
    max_tokens: int = 1024
    stop: List[str] = dataclasses.field(default_factory=list)
    # per-request deadline budget in ms (the X-Request-Deadline-Ms header
    # wins); 0 disables it, absent means resilience.request_deadline_ms
    deadline_ms: Optional[int] = None

    @classmethod
    def validate(cls, data: Any) -> "Prompt":
        errors: List[Dict[str, Any]] = []
        if _model(errors, (), data, "Prompt") is None:
            raise ValidationError(errors)
        out = {}
        if "messages" in data:
            out["messages"] = _as_list(errors, ("messages",), data["messages"], 50000,
                                       Message._validate)
        else:
            _missing(errors, ("messages",))
        if "use_knowledge_base" in data:
            out["use_knowledge_base"] = _as_bool(errors, ("use_knowledge_base",),
                                                 data["use_knowledge_base"])
        else:
            _missing(errors, ("use_knowledge_base",))
        for name in ("temperature", "top_p"):
            if name in data:
                out[name] = _as_float(errors, (name,), data[name], ge=0.1, le=1.0)
        if "max_tokens" in data:
            out["max_tokens"] = _as_int(errors, ("max_tokens",), data["max_tokens"], ge=0, le=1024)
        if "stop" in data:
            out["stop"] = _as_list(errors, ("stop",), data["stop"], 256,
                                   lambda e, loc, v: _as_str(e, loc, v, 1 << 62))
        if data.get("deadline_ms") is not None:
            out["deadline_ms"] = _as_int(errors, ("deadline_ms",), data["deadline_ms"],
                                         ge=0, le=86_400_000)
        if errors:
            raise ValidationError(errors)
        return cls(**out)

    def llm_settings(self) -> Dict[str, Any]:
        """The generation settings the server passes to a chain."""
        return {"temperature": self.temperature, "top_p": self.top_p,
                "max_tokens": self.max_tokens, "stop": list(self.stop)}


@dataclasses.dataclass
class ChainResponseChoices:
    """One streamed choice."""

    index: int = 0
    message: Message = dataclasses.field(
        default_factory=lambda: Message(role="assistant", content=""))
    finish_reason: str = ""


@dataclasses.dataclass
class ChainResponse:
    """One SSE chunk body."""

    id: str = ""
    choices: List[ChainResponseChoices] = dataclasses.field(default_factory=list)
    # structured resilience warnings; serialized only when set
    warnings: Optional[List[str]] = None

    def to_json(self) -> str:
        body: Dict[str, Any] = {
            "id": self.id,
            "choices": [{"index": c.index, "message": c.message.to_dict(),
                         "finish_reason": c.finish_reason} for c in self.choices],
        }
        if self.warnings is not None:
            body["warnings"] = list(self.warnings)
        return json.dumps(body, separators=(",", ":"), ensure_ascii=False)


@dataclasses.dataclass
class DocumentSearch:
    """The /search request body."""

    query: str = ""
    top_k: int = 4

    @classmethod
    def validate(cls, data: Any) -> "DocumentSearch":
        errors: List[Dict[str, Any]] = []
        if _model(errors, (), data, "DocumentSearch") is None:
            raise ValidationError(errors)
        out = {}
        if "query" in data:
            out["query"] = _as_str(errors, ("query",), data["query"], MAX_CONTENT_LEN)
        if "top_k" in data:
            out["top_k"] = _as_int(errors, ("top_k",), data["top_k"], ge=0, le=25)
        if errors:
            raise ValidationError(errors)
        return cls(**out)


@dataclasses.dataclass
class DocumentChunk:
    """A retrieved chunk (a numpy score becomes a Python float)."""

    content: str
    filename: str
    score: float

    def to_dict(self) -> Dict[str, Any]:
        if len(self.content) > MAX_CONTENT_LEN or len(self.filename) > 4096:
            raise ValueError("document chunk exceeds the schema's bounds")
        return {"content": self.content, "filename": self.filename, "score": float(self.score)}


@dataclasses.dataclass
class DocumentSearchResponse:
    """The /search response."""

    chunks: List[DocumentChunk]

    def to_dict(self) -> Dict[str, Any]:
        return {"chunks": [c.to_dict() for c in self.chunks]}


@dataclasses.dataclass
class DocumentsResponse:
    """The GET /documents response."""

    documents: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"documents": list(self.documents)}


@dataclasses.dataclass
class HealthResponse:
    """The GET /health response."""

    message: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {"message": self.message}


def validation_error_body(exc: ValidationError) -> Dict[str, Any]:
    """The JAX server's 422 body: FastAPI's shape, ``body`` leading every
    loc and each ctx value as a string."""
    detail = []
    for err in exc.errors:
        err = dict(err)
        if "ctx" in err:
            err["ctx"] = {k: str(v) for k, v in err["ctx"].items()}
        err["loc"] = ["body"] + list(err["loc"])
        detail.append(err)
    return {"detail": detail}
