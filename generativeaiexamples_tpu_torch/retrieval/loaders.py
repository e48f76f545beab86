"""Document loaders: a file's path to its plain text.

A copy of the JAX package's generativeaiexamples_tpu/retrieval/loaders.py:
PDF through ``retrieval/pdf.py`` (standard library only), markdown
stripped of its markup, everything else read as UTF-8 text. HTML goes
through the standard library's ``html.parser`` where JAX's goes through
``bs4`` with ``lxml``, which the GPU machine lacks: the text is the one
``BeautifulSoup(html, "lxml").get_text("\n")`` gives after dropping
``script``, ``style`` and ``noscript`` (tests/test_torch_loaders_html.py
holds the two equal and names where they part).
"""
from __future__ import annotations

import os
import re
from html.parser import HTMLParser


def load_document(path: str) -> str:
    """Extract the text content of a file for ingestion."""
    suffix = os.path.splitext(path)[1].lower()
    if suffix == ".pdf":
        from generativeaiexamples_tpu_torch.retrieval.pdf import extract_pdf_text

        return extract_pdf_text(path)
    if suffix in (".html", ".htm"):
        return _load_html(path)
    if suffix == ".md":
        return _load_markdown(path)
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        return fh.read()


def _load_html(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        parser = _HTMLText()
        parser.feed(fh.read())
        parser.close()
    return re.sub(r"\n{3,}", "\n\n", "\n".join(parser.strings)).strip()


# text under these is not text: the three JAX's loader drops, and the
# three whose strings bs4's get_text leaves out by type
_SKIPPED = frozenset({"script", "style", "noscript", "template", "rt", "rp"})
# whitespace-only text under these is kept as it is (bs4's preserve_whitespace_tags)
_PRESERVED = frozenset({"pre", "textarea"})
_VOID = frozenset({"area", "base", "br", "col", "embed", "hr", "img", "input", "link", "meta",
                   "param", "source", "track", "wbr"})
_ASCII_SPACE = " \n\t\f\r"


class _HTMLText(HTMLParser):
    """The text nodes of an HTML document, in order, as bs4 keeps them:
    a whitespace-only node becomes ``"\n"`` when it holds a newline and
    ``" "`` otherwise (outside ``pre`` and ``textarea``), and text before
    the first tag loses its leading whitespace, as lxml drops it."""

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.strings = []
        self._open = []  # the open elements, innermost last
        self._data = []
        self._tagged = False

    def _flush(self) -> None:
        text, self._data = "".join(self._data), []
        if not self._tagged:
            text = text.lstrip(_ASCII_SPACE)
        if not text or any(tag in _SKIPPED for tag in self._open):
            return
        if not text.strip(_ASCII_SPACE) and not any(tag in _PRESERVED for tag in self._open):
            text = "\n" if "\n" in text else " "
        self.strings.append(text)

    def handle_data(self, data: str) -> None:
        self._data.append(data)

    def handle_starttag(self, tag, attrs) -> None:
        self._flush()
        self._tagged = True
        if tag in ("rt", "rp") and self._open and self._open[-1] in ("rt", "rp"):
            self._open.pop()  # an rt or rp ends where the next begins
        if tag not in _VOID:
            self._open.append(tag)

    def handle_startendtag(self, tag, attrs) -> None:
        self._flush()  # "<script/>" holds nothing, as lxml reads it
        self._tagged = True

    def handle_endtag(self, tag) -> None:
        self._flush()
        if tag in self._open:  # an end tag closes what it encloses
            del self._open[len(self._open) - 1 - self._open[::-1].index(tag):]

    def handle_comment(self, data) -> None:
        self._flush()

    def handle_decl(self, decl) -> None:
        self._flush()

    def handle_pi(self, data) -> None:
        self._flush()

    def unknown_decl(self, data) -> None:
        self._flush()

    def close(self) -> None:
        super().close()
        self._flush()


def _load_markdown(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    # strip code fences and markup lightly; keep the prose
    text = re.sub(r"```.*?```", " ", text, flags=re.DOTALL)
    text = re.sub(r"[#*_`>\[\]\(\)!]", " ", text)
    return re.sub(r"[ \t]{2,}", " ", text).strip()
