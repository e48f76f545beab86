"""PPTX text and images with the standard library (``zipfile``,
``ElementTree``): the port's copy of the JAX package's
generativeaiexamples_tpu/chains/pptx_parser.py. A .pptx is a zip of
DrawingML XML: every ``<a:t>`` run of each slide, in slide order, then
its speaker notes; images are the files under ``ppt/media/``."""
from __future__ import annotations

import re
import zipfile
from typing import List
from xml.etree import ElementTree

_A_NS = "{http://schemas.openxmlformats.org/drawingml/2006/main}"


def _slide_number(name: str) -> int:
    match = re.search(r"slide(\d+)\.xml$", name)
    return int(match.group(1)) if match else 0


def extract_pptx_text(path: str) -> str:
    """All slide (and notes) text, one block a slide."""
    blocks: List[str] = []
    with zipfile.ZipFile(path) as zf:
        slide_names = sorted(
            (n for n in zf.namelist() if re.match(r"ppt/slides/slide\d+\.xml$", n)),
            key=_slide_number,
        )
        notes_names = {
            _slide_number(n): n
            for n in zf.namelist()
            if re.match(r"ppt/notesSlides/notesSlide\d+\.xml$", n)
        }
        for name in slide_names:
            num = _slide_number(name)
            texts = _runs(zf.read(name))
            if num in notes_names:
                texts += _runs(zf.read(notes_names[num]))
            if texts:
                blocks.append(f"[slide {num}]\n" + "\n".join(texts))
    return "\n\n".join(blocks)


def _runs(xml_bytes: bytes) -> List[str]:
    try:
        root = ElementTree.fromstring(xml_bytes)
    except ElementTree.ParseError:
        return []
    out: List[str] = []
    for node in root.iter(f"{_A_NS}t"):
        if node.text and node.text.strip():
            out.append(node.text.strip())
    return out


def extract_pptx_images(path: str, max_images: int = 32) -> List[bytes]:
    """The deck's media files (png, jpg, jpeg, gif, bmp) as raw bytes, in
    name order, at most ``max_images``."""
    images: List[bytes] = []
    with zipfile.ZipFile(path) as zf:
        for name in sorted(zf.namelist()):
            if re.match(r"ppt/media/.*\.(png|jpg|jpeg|gif|bmp)$", name, re.IGNORECASE):
                images.append(zf.read(name))
                if len(images) >= max_images:
                    break
    return images


def write_pptx(slides: List[List[str]], notes=None, media=None) -> bytes:
    """A minimal .pptx: one slide of DrawingML text runs for each entry of
    ``slides``, speaker notes ``{slide number: [lines]}`` and media files
    ``{name: bytes}`` under ``ppt/media/`` (the tests and chip_smoke.py)."""
    import io
    from xml.sax.saxutils import escape

    def doc(root, lines):
        runs = "".join(f"<a:p><a:r><a:t>{escape(t)}</a:t></a:r></a:p>" for t in lines)
        return ('<?xml version="1.0"?>'
                f'<p:{root} xmlns:p="http://schemas.openxmlformats.org/presentationml/2006/main" '
                'xmlns:a="http://schemas.openxmlformats.org/drawingml/2006/main">'
                f"<p:cSld><p:spTree><p:sp><p:txBody>{runs}</p:txBody></p:sp></p:spTree>"
                f"</p:cSld></p:{root}>")

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for i, lines in enumerate(slides, 1):
            zf.writestr(f"ppt/slides/slide{i}.xml", doc("sld", lines))
        for num, lines in (notes or {}).items():
            zf.writestr(f"ppt/notesSlides/notesSlide{num}.xml", doc("notes", lines))
        for name, data in (media or {}).items():
            zf.writestr(f"ppt/media/{name}", data)
    return buf.getvalue()
