"""``clean``: the chain server's text sanitizer, with the standard library.

The JAX chain server runs ``bleach.clean(value, strip=True)`` on every
message's role and content (its own answer chunks included); the card's
machine has no bleach, so this module gives the same output by the same
steps, written out for bleach's defaults:

1. tokenize as html5lib does, with bleach's changes: character references
   are left as text; a start, end or empty tag outside ``ALLOWED_TAGS``
   becomes an empty string (a newline for a block-level start tag once any
   tag was seen); comments and doctypes are dropped; a tag cut off by the
   end of the text is text again where bleach makes it so;
2. build the tree of the allowed tags as html5lib's "in body" mode does
   (the list of active formatting elements, the adoption agency,
   implied ``li`` ends), NULs dropped;
3. serialize: attributes outside ``ALLOWED_ATTRIBUTES`` and ``href``
   values of other protocols dropped; in text, invisible control
   characters become ``?``, ``&`` that starts no character reference
   becomes ``&amp;``, ``<`` and ``>`` become ``&lt;`` and ``&gt;``.

``tests/test_torch_chain_server.py`` holds it against bleach on generated
text and markup (hypothesis).
"""
from __future__ import annotations

import html.entities
import re
from typing import Dict, List, Optional

ALLOWED_TAGS = frozenset(
    ("a", "abbr", "acronym", "b", "blockquote", "code", "em", "i", "li", "ol", "strong", "ul"))
ALLOWED_ATTRIBUTES = {"a": ("href", "title"), "abbr": ("title",), "acronym": ("title",)}
ALLOWED_PROTOCOLS = frozenset(("http", "https", "mailto"))
_BLOCK_LEVEL = frozenset((
    "address", "article", "aside", "blockquote", "details", "dialog", "dd", "div", "dl", "dt",
    "fieldset", "figcaption", "figure", "footer", "form", "h1", "h2", "h3", "h4", "h5", "h6",
    "header", "hgroup", "hr", "li", "main", "nav", "ol", "p", "pre", "section", "table", "ul"))
_FORMATTING = frozenset(("a", "b", "code", "em", "i", "strong"))
_SPECIAL = frozenset(("html", "blockquote", "li", "ol", "ul"))  # of the tags that reach the tree
_SPACE = "\t\n\x0c "
_SCHEME_CHARS = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+-.")
_LETTERS = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
_INVISIBLE_RE = re.compile("[" + "".join(
    chr(c) for c in list(range(0, 9)) + list(range(11, 13)) + list(range(14, 32))) + "]")
_ENTITIES = html.entities.html5  # html5lib's table: the same 2,231 names
_PREFIXES: Optional[frozenset] = None


def _entity_prefixes() -> frozenset:
    global _PREFIXES
    if _PREFIXES is None:
        _PREFIXES = frozenset(k[:i] for k in _ENTITIES for i in range(1, len(k) + 1))
    return _PREFIXES


def _match_entity(part: str) -> Optional[str]:
    """bleach's ``match_entity``: the character reference at the start of
    ``part`` (which starts with ``&``), without ``&`` and ``;``, or None.
    It must end in ``;``; a named one need only be a prefix of a name."""
    stream = part[1:]
    ends = "<&=;" + " \t\n\r\x0b\x0c"
    i = 0
    if stream[:1] == "#":
        entity, i = "#", 1
        allowed = "0123456789"
        if stream[i:i + 1] in ("x", "X"):
            allowed = "0123456789abcdefABCDEF"
            entity += stream[i]
            i += 1
        while i < len(stream) and stream[i] not in ends:
            c = stream[i]
            i += 1
            if c not in allowed:
                break
            entity += c
        return entity if stream[i:i + 1] == ";" else None
    entity = ""
    prefixes = _entity_prefixes()
    while i < len(stream) and stream[i] not in ends:
        entity += stream[i]
        i += 1
        if entity not in prefixes:
            return None
    return entity if entity and stream[i:i + 1] == ";" else None


def _convert_entity(value: str) -> Optional[str]:
    if value[0] == "#":
        digits, base = (value[2:], 16) if value[1:2] in ("x", "X") else (value[1:], 10)
        if not digits:
            return None
        code = int(digits, base)
        return chr(code) if 0 < code < 0x110000 else None
    return _ENTITIES.get(value)


def _amp_parts(text: str) -> List[str]:
    """The text split before each ``&`` (bleach's next_possible_entity)."""
    parts = text.split("&")
    return [parts[0]] + ["&" + p for p in parts[1:]]


# --------------------------------------------------------------------- #
# 1. tokens: ("chars", text), ("start", name, attrs), ("end", name),
# ("comment",): a comment is dropped, but as a node of the tree it parts
# the texts on its two sides


class _Tokenizer:
    def __init__(self, text: str):
        self.s = text
        self.n = len(text)
        self.out: list = []
        self.seen_tag = False  # bleach's emitted_last_token

    def run(self) -> list:
        s, n, i = self.s, self.n, 0
        while i < n:
            j = s.find("<", i)
            j = n if j < 0 else j
            if j > i:
                self._text(s[i:j])
            if j >= n:
                break
            i = self._tag_open(j)
        return self.out

    def _text(self, text: str) -> None:
        # a NUL is its own token, which the tree builder ignores
        for piece in text.split("\x00"):
            if piece:
                self.out.append(("chars", piece))

    def _tag_open(self, i: int) -> int:
        s, n = self.s, self.n
        c = s[i + 1] if i + 1 < n else ""
        if c == "!":
            return self._markup_declaration(i + 2)
        if c == "/":
            c2 = s[i + 2] if i + 2 < n else ""
            if c2 in _LETTERS:
                return self._tag(i, i + 2, end=True)
            if c2 == ">":
                return i + 3
            if not c2:
                self.out.append(("chars", "</"))
                return n
            # a bogus comment: bleach makes it text unless it names an allowed tag
            k = s.find(">", i + 2)
            stop = n if k < 0 else k
            if s[i + 2:stop].replace("\x00", "�").lower().strip() not in ALLOWED_TAGS:
                self.out.append(("chars", s[i:n if k < 0 else k + 1]))
            else:
                self.out.append(("comment",))
            return n if k < 0 else k + 1
        if c in _LETTERS:
            return self._tag(i, i + 1, end=False)
        if c == "?":
            k = s.find(">", i + 1)
            self.out.append(("comment",))
            return n if k < 0 else k + 1
        self.out.append(("chars", "<"))
        return i + 1

    def _markup_declaration(self, i: int) -> int:
        s, n = self.s, self.n
        if s.startswith("--", i):
            self.out.append(("comment",))
            return self._comment(i + 2)
        # a doctype (which the tree ignores) and a bogus comment both end
        # at the next '>'
        if s[i:i + 7].lower() != "doctype":
            self.out.append(("comment",))
        k = s.find(">", i)
        return n if k < 0 else k + 1

    def _comment(self, i: int) -> int:
        s, n = self.s, self.n
        state = "start"
        while i < n:
            c = s[i]
            i += 1
            if state == "start":
                state = "start_dash" if c == "-" else ("done" if c == ">" else "comment")
            elif state == "start_dash":
                state = "end" if c == "-" else ("done" if c == ">" else "comment")
            elif state == "comment":
                if c == "-":
                    state = "end_dash"
            elif state == "end_dash":
                state = "end" if c == "-" else "comment"
            elif state == "end":
                if c == ">":
                    state = "done"
                elif c == "!":
                    state = "bang"
                elif c != "-":
                    state = "comment"
            elif state == "bang":
                state = "done" if c == ">" else ("end_dash" if c == "-" else "comment")
            if state == "done":
                return i
        return n

    def _tag(self, start: int, i: int, end: bool) -> int:
        """Tokenize a tag from its name at ``i`` (``start`` is its '<')."""
        s, n = self.s, self.n
        name = []
        attrs: list = []  # [name, value] pairs, in order
        state = "name"
        quote = ""

        def raw_text():
            self.out.append(("chars", s[start:n]))
            return n

        while True:
            c = s[i] if i < n else ""
            i += 1
            if state == "name":
                if not c:
                    return raw_text()  # eof-in-tag-name
                if c in _SPACE:
                    state = "before_attr"
                elif c == ">":
                    break
                elif c == "/":
                    state = "self_closing"
                else:
                    name.append("�" if c == "\x00" else c)
            elif state == "before_attr":
                if not c:
                    return n  # expected-attribute-name-but-got-eof: dropped
                if c in _SPACE:
                    continue
                if c == ">":
                    break
                if c == "/":
                    state = "self_closing"
                else:
                    attrs.append(["�" if c == "\x00" else c, ""])
                    state = "attr_name"
            elif state == "attr_name":
                if not c:
                    return raw_text()  # eof-in-attribute-name
                if c in _SPACE or c in "=>/":
                    attrs[-1][0] = attrs[-1][0].lower()
                    if c == ">":
                        break
                    state = {"=": "before_value", "/": "self_closing"}.get(c, "after_attr")
                else:
                    attrs[-1][0] += "�" if c == "\x00" else c
            elif state == "after_attr":
                if not c:
                    return raw_text()  # expected-end-of-tag-but-got-eof
                if c in _SPACE:
                    continue
                if c == "=":
                    state = "before_value"
                elif c == ">":
                    break
                elif c == "/":
                    state = "self_closing"
                else:
                    attrs.append(["�" if c == "\x00" else c, ""])
                    state = "attr_name"
            elif state == "before_value":
                if not c:
                    return n  # expected-attribute-value-but-got-eof: dropped
                if c in _SPACE:
                    continue
                if c in "\"'":
                    quote, state = c, "quoted"
                elif c == ">":
                    break
                else:
                    attrs[-1][1] += "�" if c == "\x00" else c
                    state = "unquoted"
            elif state == "quoted":
                if not c:
                    return n  # eof in a quoted value: dropped
                if c == quote:
                    state = "after_value"
                else:
                    attrs[-1][1] += "�" if c == "\x00" else c
            elif state == "after_value":
                if not c:
                    return n  # unexpected-EOF-after-attribute-value: dropped
                if c in _SPACE:
                    state = "before_attr"
                elif c == ">":
                    break
                elif c == "/":
                    state = "self_closing"
                else:
                    i -= 1
                    state = "before_attr"
            elif state == "unquoted":
                if not c:
                    return raw_text()  # eof-in-attribute-value-no-quotes
                if c in _SPACE:
                    state = "before_attr"
                elif c == ">":
                    break
                else:
                    attrs[-1][1] += "�" if c == "\x00" else c
            elif state == "self_closing":
                if not c:
                    return n  # unexpected-EOF-after-solidus-in-tag: dropped
                if c == ">":
                    break
                i -= 1
                state = "before_attr"
        tag = "".join(name).lower()
        if tag not in ALLOWED_TAGS:
            block = not end and self.seen_tag and tag in _BLOCK_LEVEL
            self.out.append(("chars", "\n" if block else ""))
        elif end:
            self.out.append(("end", tag))
        else:
            first: Dict[str, str] = {}
            for key, value in attrs:
                first.setdefault(key, value)  # the first of duplicates wins
            self.out.append(("start", tag, first))
        self.seen_tag = True
        return i


# --------------------------------------------------------------------- #
# 2. the tree of the allowed tags


class _Element:
    __slots__ = ("name", "attrs", "children", "parent")

    def __init__(self, name: str, attrs: Dict[str, str]):
        self.name = name
        self.attrs = attrs
        self.children: list = []
        self.parent: Optional[_Element] = None

    def clone(self) -> "_Element":
        return _Element(self.name, dict(self.attrs))

    def append(self, node) -> None:
        if isinstance(node, str):
            if not node:
                return
            if self.children and isinstance(self.children[-1], str):
                self.children[-1] += node
                return
        elif node is not _COMMENT:
            node.parent = self
        self.children.append(node)

    def remove(self, node: "_Element") -> None:
        k = next(k for k, ch in enumerate(self.children) if ch is node)
        del self.children[k]
        node.parent = None

    def reparent_children(self, other: "_Element") -> None:
        for ch in self.children:
            if not isinstance(ch, str) and ch is not _COMMENT:
                ch.parent = None
            other.append(ch)
        self.children = []


_COMMENT = _Element("#comment", {})  # dropped when serialized


def _index(seq: list, node) -> int:
    return next(k for k, x in enumerate(seq) if x is node)


def _contains(seq: list, node) -> bool:
    return any(x is node for x in seq)


class _TreeBuilder:
    """html5lib's "in body" insertion mode, for the allowed tags only."""

    def __init__(self):
        self.root = _Element("html", {})
        self.stack: List[_Element] = [self.root]
        self.afe: List[_Element] = []  # no markers: none of the allowed tags sets one

    def feed(self, tokens: list) -> _Element:
        for tok in tokens:
            if tok[0] == "chars":
                self.reconstruct()
                self.stack[-1].append(tok[1])
            elif tok[0] == "comment":
                self.stack[-1].append(_COMMENT)
            elif tok[0] == "start":
                self.start(tok[1], tok[2])
            else:
                self.end(tok[1])
        return self.root

    def insert(self, name: str, attrs: Dict[str, str]) -> _Element:
        el = _Element(name, attrs)
        self.stack[-1].append(el)
        self.stack.append(el)
        return el

    def in_scope(self, name: str, list_scope: bool = False) -> bool:
        for node in reversed(self.stack):
            if node.name == name:
                return True
            if node.name == "html" or (list_scope and node.name in ("ol", "ul")):
                return False
        return False

    def afe_find(self, name: str) -> Optional[_Element]:
        for node in reversed(self.afe):
            if node.name == name:
                return node
        return None

    def reconstruct(self) -> None:
        if not self.afe or _contains(self.stack, self.afe[-1]):
            return
        i = len(self.afe) - 1
        while not _contains(self.stack, self.afe[i]):
            if i == 0:
                i = -1
                break
            i -= 1
        while True:
            i += 1
            entry = self.afe[i]
            el = self.insert(entry.name, dict(entry.attrs))
            self.afe[i] = el
            if el is self.afe[-1]:
                break

    def add_formatting(self, name: str, attrs: Dict[str, str]) -> None:
        el = self.insert(name, attrs)
        same = [n for n in reversed(self.afe) if n.name == el.name and n.attrs == el.attrs]
        if len(same) == 3:
            self.afe.remove(same[-1])
        self.afe.append(el)

    def implied_ends(self, exclude: str = "") -> None:
        while self.stack[-1].name == "li" and exclude != "li":
            self.stack.pop()

    def pop_until(self, name: str) -> None:
        while self.stack.pop().name != name:
            pass

    def start(self, name: str, attrs: Dict[str, str]) -> None:
        if name == "a":
            old = self.afe_find("a")
            if old is not None:
                self.adoption_agency("a")
                if _contains(self.stack, old):
                    del self.stack[_index(self.stack, old)]
                if _contains(self.afe, old):
                    del self.afe[_index(self.afe, old)]
            self.reconstruct()
            self.add_formatting(name, attrs)
        elif name in _FORMATTING:
            self.reconstruct()
            self.add_formatting(name, attrs)
        elif name in ("blockquote", "ol", "ul"):
            self.insert(name, attrs)  # no <p> can be open to close
        elif name == "li":
            for node in reversed(self.stack):
                if node.name == "li":
                    self.end("li")
                    break
                if node.name in _SPECIAL:
                    break
            self.insert(name, attrs)
        else:  # abbr, acronym
            self.reconstruct()
            self.insert(name, attrs)

    def end(self, name: str) -> None:
        if name in ("blockquote", "ol", "ul"):
            if self.in_scope(name):
                self.implied_ends()
                self.pop_until(name)
        elif name == "li":
            if self.in_scope("li", list_scope=True):
                self.implied_ends(exclude="li")
                self.pop_until("li")
        elif name in _FORMATTING:
            self.adoption_agency(name)
        else:
            self.end_other(name)

    def end_other(self, name: str) -> None:
        for node in reversed(self.stack):
            if node.name == name:
                self.implied_ends(exclude=name)
                while self.stack.pop() is not node:
                    pass
                return
            if node.name in _SPECIAL:
                return

    def adoption_agency(self, name: str) -> None:
        for _ in range(8):
            fmt = self.afe_find(name)
            if fmt is None or (_contains(self.stack, fmt) and not self.in_scope(fmt.name)):
                self.end_other(name)
                return
            if not _contains(self.stack, fmt):
                del self.afe[_index(self.afe, fmt)]
                return
            k = _index(self.stack, fmt)
            furthest = next((el for el in self.stack[k:] if el.name in _SPECIAL), None)
            if furthest is None:
                while self.stack.pop() is not fmt:
                    pass
                del self.afe[_index(self.afe, fmt)]
                return
            common = self.stack[k - 1]
            bookmark = _index(self.afe, fmt)
            last = node = furthest
            index = _index(self.stack, node)
            for _ in range(3):
                index -= 1
                node = self.stack[index]
                if not _contains(self.afe, node):
                    del self.stack[_index(self.stack, node)]
                    continue
                if node is fmt:
                    break
                if last is furthest:
                    bookmark = _index(self.afe, node) + 1
                clone = node.clone()
                self.afe[_index(self.afe, node)] = clone
                self.stack[_index(self.stack, node)] = clone
                node = clone
                if last.parent is not None:
                    last.parent.remove(last)
                node.append(last)
                last = node
            if last.parent is not None:
                last.parent.remove(last)
            common.append(last)
            clone = fmt.clone()
            furthest.reparent_children(clone)
            furthest.append(clone)
            del self.afe[_index(self.afe, fmt)]
            self.afe.insert(bookmark, clone)
            del self.stack[_index(self.stack, fmt)]
            self.stack.insert(_index(self.stack, furthest) + 1, clone)


# --------------------------------------------------------------------- #
# 3. serialization


def _uri_allowed(value: str) -> bool:
    """bleach's ``sanitize_uri_value`` for the default protocols, with the
    scheme split of the ``urlsplit`` that bleach vendors."""
    parts = []
    for part in _amp_parts(value):
        if part.startswith("&"):
            entity = _match_entity(part)
            converted = _convert_entity(entity) if entity is not None else None
            if converted is not None:
                parts.append(converted + part[len(entity) + 2:])
                continue
        parts.append(part)
    uri = re.sub(r"[`\000-\040\177-\240\s]+", "", "".join(parts))
    uri = re.sub(r"[^\x00-\x7f]", "", uri).lower()
    scheme, rest = "", uri
    i = uri.find(":")
    if i > 0 and (uri[:i] == "http" or (
            all(c in _SCHEME_CHARS for c in uri[:i])
            and (not uri[i + 1:] or any(c not in "0123456789" for c in uri[i + 1:])))):
        scheme, rest = uri[:i], uri[i + 1:]
    if rest[:2] == "//":
        netloc = re.split(r"[/?#]", rest[2:], maxsplit=1)[0]
        if ("[" in netloc) != ("]" in netloc):
            return False  # urlsplit's "Invalid IPv6 URL"
    if scheme:
        return scheme in ALLOWED_PROTOCOLS
    return True  # no scheme: allowed while http or https is


def _attr_value(value: str) -> str:
    v = value.replace("&", "&amp;").replace("<", "&lt;")
    quote = '"'
    if "'" in v and '"' not in v:
        quote = '"'
    elif '"' in v and "'" not in v:
        quote = "'"
    if quote == "'":
        # bleach re-escapes bare '&' only in a double-quoted value
        return "'" + v.replace("'", "&#39;") + "'"
    out = []
    for part in _amp_parts(v.replace('"', "&quot;").replace("&amp;", "&")):
        if part.startswith("&"):
            entity = _match_entity(part)
            if entity is not None and _convert_entity(entity) is not None:
                out.append(f"&{entity};" + part[len(entity) + 2:])
                continue
        out.append(part.replace("&", "&amp;"))
    return '"' + "".join(out) + '"'


def _characters(text: str) -> str:
    """A text node's middle: invisible characters to '?', character
    references kept, the rest escaped."""
    text = _INVISIBLE_RE.sub("?", text)
    out = []
    for part in _amp_parts(text):
        if part.startswith("&"):
            entity = _match_entity(part)
            if entity is not None:
                rest = part[len(entity) + 2:]
                out.append("&amp;" if entity == "amp" else f"&{entity};")
                out.append(_escape(rest))
                continue
        out.append(_escape(part))
    return "".join(out)


def _escape(text: str) -> str:
    return text.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")


def _serialize(node: _Element, out: List[str]) -> None:
    for ch in node.children:
        if isinstance(ch, str):
            middle = ch.lstrip(_SPACE)
            left = ch[: len(ch) - len(middle)]
            core = middle.rstrip(_SPACE)
            out.append(left + _characters(core) + middle[len(core):])
            continue
        if ch is _COMMENT:
            continue
        allowed = ALLOWED_ATTRIBUTES.get(ch.name, ())
        attrs = "".join(
            f" {k}={_attr_value(v)}" for k, v in ch.attrs.items()
            if k in allowed and (k != "href" or _uri_allowed(v)))
        out.append(f"<{ch.name}{attrs}>")
        _serialize(ch, out)
        out.append(f"</{ch.name}>")


def clean(text: str) -> str:
    """``bleach.clean(text, strip=True)`` with bleach's default tags,
    attributes and protocols."""
    if not text:
        return ""
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    root = _TreeBuilder().feed(_Tokenizer(text).run())
    out: List[str] = []
    _serialize(root, out)
    return "".join(out)
