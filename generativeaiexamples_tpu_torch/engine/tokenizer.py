"""Tokenization for the port's engine.

A copy of the JAX package's generativeaiexamples_tpu/engine/tokenizer.py,
trimmed to what the serving slice uses:

- ``ByteTokenizer``: bytes 0..255 plus specials; the tokenizer the engine
  runs with until a ``tokenizer.json`` ships with real weights;
- ``HFTokenizer``: a HuggingFace ``tokenizer.json`` (Llama-3 BPE) with the
  Llama-3 chat template applied by hand. It imports ``tokenizers`` only
  when built, so the package imports without it;
- the tokenization caches the chains and the LLM backend use
  (``encode_cached``, ``chat_preamble_ids``, ``render_chat_cached``,
  ``clear_tokenization_caches``).
"""
from __future__ import annotations

import functools
import os
from typing import List, Optional, Protocol, Sequence, Tuple


class ChatMessage(Protocol):
    role: str
    content: str


class Tokenizer(Protocol):
    vocab_size: int
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str, add_bos: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def stop_ids(self) -> List[int]: ...

    def render_chat(self, messages: Sequence[Tuple[str, str]]) -> List[int]: ...

    def render_chat_prefix(self, messages: Sequence[Tuple[str, str]]) -> List[int]: ...

    def render_chat_suffix(self, messages: Sequence[Tuple[str, str]]) -> List[int]: ...


class ByteTokenizer:
    """Bytes 0..255 plus specials; vocab padded to 512 (debug preset)."""

    # id-level concatenation: splitting a render anywhere is exact
    supports_split_render = True

    def __init__(self) -> None:
        self.vocab_size = 512
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self._role_ids = {"system": 259, "user": 260, "assistant": 261}
        self._turn_end = 262
        # BERT-style specials for the cross-encoder path
        self.cls_id = 263
        self.sep_id = 264

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def stop_ids(self) -> List[int]:
        return [self.eos_id, self._turn_end]

    def render_chat(self, messages: Sequence[Tuple[str, str]]) -> List[int]:
        return self.render_chat_prefix(messages) + self.render_chat_suffix(())

    def render_chat_prefix(self, messages: Sequence[Tuple[str, str]]) -> List[int]:
        """Leading chat blocks (BOS + message turns, no assistant
        header): ``render_chat(m) == render_chat_prefix(m[:k]) +
        render_chat_suffix(m[k:])`` for any split point k — the contract
        chains/runtime.py's cached-preamble path relies on."""
        ids = [self.bos_id]
        for role, content in messages:
            ids.append(self._role_ids.get(role, self._role_ids["user"]))
            ids.extend(self.encode(content))
            ids.append(self._turn_end)
        return ids

    def render_chat_suffix(self, messages: Sequence[Tuple[str, str]]) -> List[int]:
        """Trailing chat blocks + the assistant header (no BOS)."""
        ids: List[int] = []
        for role, content in messages:
            ids.append(self._role_ids.get(role, self._role_ids["user"]))
            ids.extend(self.encode(content))
            ids.append(self._turn_end)
        ids.append(self._role_ids["assistant"])
        return ids


# Llama-3 special tokens (model card); used when a real tokenizer.json loads.
_L3_BEGIN = "<|begin_of_text|>"
_L3_SH = "<|start_header_id|>"
_L3_EH = "<|end_header_id|>"
_L3_EOT = "<|eot_id|>"


class HFTokenizer:
    """HuggingFace tokenizers-backed BPE with the Llama-3 chat template."""

    def __init__(self, tokenizer_json: str):
        from tokenizers import Tokenizer as _Tok

        self._tok = _Tok.from_file(tokenizer_json)
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = self._id_or(_L3_BEGIN, 0)
        self.eos_id = self._id_or("<|end_of_text|>", 1)
        self.eot_id = self._id_or(_L3_EOT, self.eos_id)
        self.pad_id = self.eos_id
        # BERT-family specials (present in WordPiece tokenizer.json files;
        # fall back to bos/eos for BPE vocabularies)
        self.cls_id = self._id_or("[CLS]", self.bos_id)
        self.sep_id = self._id_or("[SEP]", self.eos_id)
        # Split-rendering (render_chat_prefix + render_chat_suffix ==
        # render_chat) is exact ONLY when the pre-tokenizer never merges
        # across the template's boundary markers. Vocabulary PRESENCE is
        # not enough (a base-vocab marker can still merge with its
        # neighbours), so probe the actual boundary the cached render
        # splits at: encode a text straddling it both whole and split,
        # and require the markers to encode atomically. Tokenizers that
        # fail the probe fall back to whole-string rendering in
        # render_chat_cached.
        self.supports_split_render = self._probe_split_render()

    def _probe_split_render(self) -> bool:
        def enc(text: str) -> List[int]:
            return self._tok.encode(text, add_special_tokens=False).ids

        try:
            head = f"x{_L3_EOT}"  # prefix side always ends with <|eot_id|>
            tail = f"{_L3_SH}assistant{_L3_EH}\n\ny"  # suffix side start
            return enc(head + tail) == enc(head) + enc(tail) and all(
                len(enc(t)) == 1
                for t in (_L3_BEGIN, _L3_SH, _L3_EH, _L3_EOT)
            )
        except Exception:  # noqa: BLE001 - any doubt means fall back
            return False

    def _id_or(self, token: str, fallback: int) -> int:
        tid = self._tok.token_to_id(token)
        return tid if tid is not None else fallback

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def stop_ids(self) -> List[int]:
        return [self.eos_id, self.eot_id]

    def render_chat(self, messages: Sequence[Tuple[str, str]]) -> List[int]:
        text = _L3_BEGIN
        for role, content in messages:
            text += f"{_L3_SH}{role}{_L3_EH}\n\n{content}{_L3_EOT}"
        text += f"{_L3_SH}assistant{_L3_EH}\n\n"
        return self._tok.encode(text, add_special_tokens=False).ids

    def render_chat_prefix(self, messages: Sequence[Tuple[str, str]]) -> List[int]:
        """Leading chat blocks. Split-encoding equals whole-string
        encoding because every split boundary lands on a Llama-3
        special token (<|eot_id|> / <|start_header_id|>), which the
        added-token pre-tokenizer never merges across."""
        text = _L3_BEGIN
        for role, content in messages:
            text += f"{_L3_SH}{role}{_L3_EH}\n\n{content}{_L3_EOT}"
        return self._tok.encode(text, add_special_tokens=False).ids

    def render_chat_suffix(self, messages: Sequence[Tuple[str, str]]) -> List[int]:
        """Trailing chat blocks + the assistant header (no BOS)."""
        text = ""
        for role, content in messages:
            text += f"{_L3_SH}{role}{_L3_EH}\n\n{content}{_L3_EOT}"
        text += f"{_L3_SH}assistant{_L3_EH}\n\n"
        return self._tok.encode(text, add_special_tokens=False).ids


# --------------------------------------------------------------------- #
# Tokenization caches: every chain front-loads the same static preamble
# (its system prompt) on every request, a pure function of (tokenizer,
# text). Keys hold the tokenizer object itself (identity hash: the
# engine's tokenizer lives as long as the engine).


@functools.lru_cache(maxsize=512)
def _encode_lru(tokenizer, text: str, add_bos: bool) -> Tuple[int, ...]:
    return tuple(tokenizer.encode(text, add_bos=add_bos))


def encode_cached(tokenizer, text: str, add_bos: bool = False) -> List[int]:
    """LRU-cached ``tokenizer.encode`` for repeated identical texts."""
    return list(_encode_lru(tokenizer, text, add_bos))


@functools.lru_cache(maxsize=64)
def chat_preamble_ids(tokenizer, role: str, content: str) -> Tuple[int, ...]:
    """The rendered leading chat message (a chain's system prompt), encoded
    once per process."""
    return tuple(tokenizer.render_chat_prefix(((role, content),)))


def render_chat_cached(tokenizer, messages: Sequence[Tuple[str, str]]) -> List[int]:
    """``tokenizer.render_chat(messages)`` with a leading system message
    served from ``chat_preamble_ids``; only the per-request tail is
    encoded. The ids equal ``render_chat``'s: the split lands on template
    special ids, and a tokenizer that cannot split there
    (``supports_split_render`` False) renders whole."""
    msgs = list(messages)
    if msgs and msgs[0][0] == "system" and getattr(tokenizer, "supports_split_render", False):
        head = chat_preamble_ids(tokenizer, msgs[0][0], msgs[0][1])
        return list(head) + tokenizer.render_chat_suffix(msgs[1:])
    return tokenizer.render_chat(msgs)


def clear_tokenization_caches() -> None:
    """Drop the encode and preamble caches (they hold the tokenizers)."""
    _encode_lru.cache_clear()
    chat_preamble_ids.cache_clear()


def load_tokenizer(path: Optional[str] = None) -> Tokenizer:
    """Load the configured tokenizer; byte-level fallback when absent."""
    if path:
        candidate = path
        if os.path.isdir(path):
            candidate = os.path.join(path, "tokenizer.json")
        if os.path.exists(candidate):
            return HFTokenizer(candidate)
    return ByteTokenizer()
