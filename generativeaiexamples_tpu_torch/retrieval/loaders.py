"""Document loaders: a file's path to its plain text.

A copy of the JAX package's generativeaiexamples_tpu/retrieval/loaders.py:
PDF through ``retrieval/pdf.py`` (standard library only), HTML through
``bs4`` (imported when an HTML file is loaded, so a machine without it
fails only there), markdown stripped of its markup, everything else read
as UTF-8 text.
"""
from __future__ import annotations

import os
import re


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
    from bs4 import BeautifulSoup

    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        soup = BeautifulSoup(fh.read(), "lxml")
    for tag in soup(["script", "style", "noscript"]):
        tag.decompose()
    return re.sub(r"\n{3,}", "\n\n", soup.get_text("\n")).strip()


def _load_markdown(path: str) -> str:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        text = fh.read()
    # strip code fences and markup lightly; keep the prose
    text = re.sub(r"```.*?```", " ", text, flags=re.DOTALL)
    text = re.sub(r"[#*_`>\[\]\(\)!]", " ", text)
    return re.sub(r"[ \t]{2,}", " ", text).strip()
