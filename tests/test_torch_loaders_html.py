"""The port's HTML loader (standard library ``html.parser``) against the JAX
package's (``bs4`` with ``lxml``) on the CPU: ``load_document`` gives the
same text for the HTML of notebook 06, of the port's and JAX's tests, of
chip_smoke.py phase 22's generator and of a set of hand-written pages.

Where the two part (named below, each held to what the port gives):
- text straight after the head's content with no ``<body>`` tag: lxml
  moves its leading whitespace into the head as a node of its own, so
  ``<title>t</title> hello`` reads ``t\\n \\nhello`` there and ``t\\n
  hello`` here."""
import ast
import json
import pathlib

import numpy as np
import pytest

import chip_smoke
from generativeaiexamples_tpu.retrieval.loaders import load_document as jax_load
from generativeaiexamples_tpu_torch.retrieval import loaders
from generativeaiexamples_tpu_torch.retrieval.loaders import load_document

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _notebook_06_page() -> str:
    """The page notebook 06 writes (the triple-quoted argument of its
    ``page.write_text``)."""
    nb = json.loads((ROOT / "notebooks" / "06_html_doc_rag.ipynb").read_text())
    for cell in nb["cells"]:
        src = "".join(cell["source"])
        if "page.write_text(" in src:
            return src.split('page.write_text("""', 1)[1].split('""")', 1)[0]
    raise AssertionError("notebook 06 writes no page")


PAGES = {
    "notebook_06": _notebook_06_page(),
    # tests/test_torch_chain_runtime.py's d.html and tests/test_retrieval.py's page
    "chain_runtime": "<html><script>x()</script><body><h1>T</h1><p>some words here</p></body></html>",
    "jax_retrieval": "<html><script>x()</script><body><h1>Title</h1><p>Body text.</p></body></html>",
    "doctype_indented": ("<!DOCTYPE html>\n<html>\n <head>\n  <title>T</title>\n </head>\n <body>\n"
                         "  <p>x</p>\n  <!-- c -->\n  <p>y &amp; z</p>\n </body>\n</html>\n"),
    "spaces_everywhere": "<html> <head> <title>T</title> </head> <body> <p>x</p> </body> </html> ",
    "leading_text": " x <p>a</p>",
    "leading_space": "  <p> a </p>  \n <div>\n <span>x</span> <b>y</b>\n</div>\n",
    "list": "<ul>\n<li>one</li>\n<li>two</li>\n</ul>",
    "table": "<table><tr><td>1</td> <td>2</td></tr></table>",
    "comment_br": "a<!--c-->b<br>c<br/>d",
    "after_html": "<html><body><p>a</p></body></html>\n\n<p>after</p>",
    "pre_textarea": "<p>x</p><pre>  a\n  b  </pre><textarea>  </textarea><pre>\n\n\n\n</pre>",
    "template_ruby": ("<div>a<template>t<p>u</p></template><ruby>漢<rp>(</rp><rt>kan</rt>"
                      "<rp>)</rp></ruby></div>"),
    "entities": "<p>caf&eacute; &lt;tag&gt; &#169; &nbsp;x &amp;amp;</p>",
    "unclosed": "<p>unclosed <b>bold <i>it</p> after",
    "noscript_nested": ("<body><noscript><p>enable js</p></noscript><div><style>.a{}</style>"
                        "<p>kept</p><script>if (a < b) { document.write('</p>') }</script>"
                        "</div></body>"),
    "blank_runs": "<p>a</p>\n\n\n\n<p>b</p>\n \n\t\n<div>\n\n</div><p>c</p>",
    "meta_link": ('<html><head><meta charset="utf-8"><link rel="x" href="y">'
                  "<title>Q3</title></head><body><h2>Revenue</h2><p>$41.2M</p></body></html>"),
    "self_closed": "<p>a</p><script/><p>b</p><div/>x<div/>y",
    "cdata_pi_select": ("<?php echo 1 ?><p>1</p><![CDATA[zz]]><p>2</p><select><option>a</option>"
                        "<option>b</option></select><p>x<noscript>n</noscript>y</p>"),
    "plain_text": "text only, no tags",
    "empty": "",
}
# where the two loaders part (module docstring): the page and the port's text
DIFFERENT = {
    "head_then_text": ("<title>t</title> hello", "t\n hello"),
}


def _write(tmp_path, name, html) -> str:
    path = tmp_path / f"{name}.html"
    path.write_text(html, encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("name", sorted(PAGES))
def test_text_equals_jax_bs4(tmp_path, name):
    path = _write(tmp_path, name, PAGES[name])
    assert load_document(path) == jax_load(path)


def test_phase_22_generator_pages_equal_jax_bs4(tmp_path):
    """Every .html file chip_smoke.py phase 22 writes (16 of its 96)."""
    corpus = chip_smoke._agents_corpus(np.random.RandomState(0), str(tmp_path))
    pages = [path for path, _ in corpus["files"] if path.endswith(".html")]
    assert len(pages) == 16
    for path in pages:
        text = load_document(path)
        assert text == jax_load(path)
        assert "margin" not in text and text.count("\n") > 0


@pytest.mark.parametrize("name", sorted(DIFFERENT))
def test_named_departures_from_jax_bs4(tmp_path, name):
    html, ours = DIFFERENT[name]
    path = _write(tmp_path, name, html)
    assert load_document(path) == ours
    assert jax_load(path) != ours


def test_loader_needs_no_bs4():
    """The port's loader module imports no HTML library beyond the
    standard one (the GPU machine has neither bs4 nor lxml)."""
    tree = ast.parse(pathlib.Path(loaders.__file__).read_text())
    imported = {alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                for alias in node.names}
    imported |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert "html.parser" in imported
    assert not {m for m in imported if m and m.split(".")[0] in ("bs4", "lxml", "html5lib")}
