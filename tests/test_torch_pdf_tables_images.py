"""The port's PDF tables and images (generativeaiexamples_tpu_torch/
retrieval/pdf.py) and PPTX parser (chains/pptx_parser.py) against the JAX
package's, on the CPU, at equality: the same bytes go through both.

- tables on seeded grids and on generated ones (hypothesis: rows, columns
  and cell text), ``stringify_table``, prose that is not a table;
- images: DCTDecode passed through, FlateDecode Gray/RGB/CMYK re-encoded
  to PNG, the one end-of-line stripped before ``endstream`` (a zlib body
  that ends in 0x0a), indirect references refused by ``_dict_int``,
  ``max_images``, and FlateDecode skipped without PIL (``sys.modules``
  hides it) while DCTDecode still passes;
- ``streams=`` reuse, and a whole written document (text, table, images);
- PPTX text (slides in number order, notes, a malformed slide) and media.
  Speaker notes never join a slide's text in either package (the notes'
  file names do not match ``_slide_number``'s pattern).
"""
import io
import sys
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from generativeaiexamples_tpu.chains import pptx_parser as jpptx
from generativeaiexamples_tpu.retrieval import pdf as jpdf
from generativeaiexamples_tpu_torch.chains import pptx_parser as tpptx
from generativeaiexamples_tpu_torch.retrieval import pdf as tpdf


def _write(tmp_path, name, data: bytes) -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _both(fn_name, *args, mod=(jpdf, tpdf), **kwargs):
    """``fn_name`` of each package on the same arguments; equal, returned."""
    want = getattr(mod[0], fn_name)(*args, **kwargs)
    got = getattr(mod[1], fn_name)(*args, **kwargs)
    assert got == want
    return got


def _words(rng, n, lo=3, hi=9):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
    return ["".join(rng.choice(letters, int(rng.randint(lo, hi)))) for _ in range(n)]


def _jpeg(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _image_obj(head_extra: bytes, body: bytes) -> bytes:
    return (b"<< /Type /XObject /Subtype /Image " + head_extra + b" /Length "
            + str(len(body)).encode() + b" >>\nstream\n" + body + b"\nendstream\n")


def _flate_obj(raw: bytes, w: int, h: int, space=b"/DeviceRGB", bpc=b"8") -> bytes:
    return _image_obj(b"/Width " + str(w).encode() + b" /Height " + str(h).encode()
                      + b" /BitsPerComponent " + bpc + b" /ColorSpace " + space
                      + b" /Filter /FlateDecode", zlib.compress(raw))


# --------------------------------------------------------------------------- #
# tables


@pytest.mark.parametrize("seed", range(6))
def test_tables_on_seeded_grids(tmp_path, seed):
    rng = np.random.RandomState(seed)
    grids = []
    for _ in range(int(rng.randint(1, 3))):
        rows, cols = int(rng.randint(2, 13)), int(rng.randint(2, 7))
        grids.append([_words(rng, cols) for _ in range(rows)])
    pages = [(tpdf.table_ops(g, y=700 - 10 * k), []) for k, g in enumerate(grids)]
    pages.append((tpdf.text_ops(["A line of prose.", "And another one."]), []))
    path = _write(tmp_path, "t.pdf", tpdf.write_pdf(pages))
    assert _both("extract_pdf_tables", path) == grids
    for g in grids:
        assert _both("stringify_table", g) == "\n".join(" | ".join(r) for r in g)


_CELL = st.text(alphabet="abcdefghijklmnopqrstuvwxyz0123456789 ()\\-.,", min_size=1,
                max_size=12).filter(lambda s: s.strip())


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(2, 8).flatmap(
    lambda cols: st.lists(st.lists(_CELL, min_size=cols, max_size=cols), min_size=2, max_size=8)))
def test_tables_property(grid):
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/g.pdf"
        with open(path, "wb") as fh:
            fh.write(tpdf.write_pdf([(tpdf.table_ops(grid), [])]))
        got = _both("extract_pdf_tables", path)
        assert got == [[[c.strip() for c in row] for row in grid]]


def test_a_table_whose_deflated_stream_ends_in_an_end_of_line(tmp_path):
    """A grid whose content stream's adler32 (the last bytes of its deflate
    output at every level) ends in a line feed: the writer pads the
    content until a level fits, and both packages read the table back."""
    grid = [["0", "q", "3\\,bfnsv"], ["h", "dv", "11)boy"], ["m", "z", "09\\,( v"],
            ["s", ")fx", "01188bknntuv"], ["w", "0clsu", "11)boy"], ["9z", "09ptw", "afmort"],
            ["17 b", "0,,eepq", "013,, cgjlpz"], ["038dkkmq", "0458)bgklqux", "88(  bhhkyzz"]]
    content = tpdf.table_ops(grid)
    assert all(zlib.compress(content, level).endswith(b"\n") for level in range(10))
    path = _write(tmp_path, "g.pdf", tpdf.write_pdf([(content, [])]))
    assert _both("extract_pdf_tables", path) == [[[c.strip() for c in row] for row in grid]]


def test_prose_is_not_a_table(tmp_path):
    ops = b"BT\n1 0 0 1 72 700 Tm (one line) Tj\n1 0 0 1 72 680 Tm (another line) Tj\nET"
    body = b"<< /Length " + str(len(ops)).encode() + b" >>\nstream\n" + ops + b"\nendstream\n"
    path = _write(tmp_path, "p.pdf", b"%PDF-1.4\n" + body + b"\n%%EOF\n")
    assert _both("extract_pdf_tables", path) == []
    # Tm moves break no line in the text pass
    assert _both("extract_pdf_text", path) == "one lineanother line"


def test_positioning_operators(tmp_path):
    """Td, TD (which sets the leading), TL, T*, ' and TJ arrays place runs as in JAX."""
    ops = (b"BT 72 700 Td (a) Tj 100 0 Td (b) Tj -100 -20 TD (c) Tj 100 0 Td (d) Tj "
           b"14 TL T* (e) Tj (f) ' [(g) -20 (h)] TJ ET")
    data = tpdf._compressed(ops)
    body = (b"<< /Length " + str(len(data)).encode() + b" /Filter /FlateDecode >>\nstream\n"
            + data + b"\nendstream\n")
    path = _write(tmp_path, "ops.pdf", b"%PDF-1.4\n" + body + b"%%EOF\n")
    streams = list(tpdf.iter_content_streams(path))
    assert streams == list(jpdf.iter_content_streams(path))
    assert tpdf._extract_stream_runs(streams[0]) == jpdf._extract_stream_runs(streams[0])
    assert _both("extract_pdf_tables", path) == [[["a", "b"], ["c", "d"]]]


@pytest.mark.parametrize("runs", [
    [(72, 700, "x"), (200, 701.5, "y"), (72, 680, "z"), (201, 680, "w")],
    [(72, 700, "x"), (200, 697, "y")],
    [(1, 1, "a")],
    [],
])
def test_rows_and_columns(runs):
    rows = _both("_runs_to_rows", runs)
    for a in rows:
        for b in rows:
            xa, xb = [r[0] for r in a], [r[0] for r in b]
            assert tpdf._columns_match(xa, xb) == jpdf._columns_match(xa, xb)


# --------------------------------------------------------------------------- #
# images


def _seeded_rgb(seed, w=24, h=16):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


def test_images_of_every_encoding(tmp_path):
    rgb = _seeded_rgb(0)
    gray = _seeded_rgb(1)[..., 0].copy()
    cmyk = np.random.RandomState(2).randint(0, 256, (8, 8, 4)).astype(np.uint8)
    jpeg = _jpeg(_seeded_rgb(3, 32, 32))
    body = (_image_obj(b"/Width 32 /Height 32 /BitsPerComponent 8 /Filter /DCTDecode", jpeg)
            + _flate_obj(rgb.tobytes(), 24, 16)
            + _flate_obj(gray.tobytes(), 24, 16, b"/DeviceGray")
            + _flate_obj(cmyk.tobytes(), 8, 8, b"/DeviceCMYK")
            + _flate_obj(rgb.tobytes(), 24, 16, bpc=b"16")  # skipped: 16 bits
            + _image_obj(b"/Width 4 /Height 4 /Filter /JBIG2Decode", b"\x00" * 8)  # skipped
            + _image_obj(b"/Width 4 /Height 4 /Filter /DCTDecode", b"not a jpeg"))  # skipped
    path = _write(tmp_path, "i.pdf", b"%PDF-1.4\n" + body + b"%%EOF\n")
    images = _both("extract_pdf_images", path)
    assert len(images) == 4 and images[0] == jpeg
    decoded = [np.asarray(Image.open(io.BytesIO(b))) for b in images[1:]]
    assert np.array_equal(decoded[0], rgb)
    assert np.array_equal(decoded[1], np.repeat(gray[..., None], 3, axis=2))
    assert decoded[2].shape == (8, 8, 3)
    assert _both("extract_pdf_images", path, max_images=2) == images[:2]


def test_exactly_one_eol_is_stripped_before_endstream(tmp_path):
    """A zlib body ending in 0x0a keeps that byte: rstrip would corrupt it."""
    for seed in range(5000):
        raw = _seeded_rgb(seed, 8, 8).tobytes()
        if zlib.compress(raw).endswith(b"\n"):
            break
    else:
        raise AssertionError("no seed gives a zlib body ending in 0x0a")
    for eol in (b"\n", b"\r\n", b"\r"):
        obj = _flate_obj(raw, 8, 8).replace(b"\nendstream", eol + b"endstream")
        path = _write(tmp_path, "eol.pdf", b"%PDF-1.4\n" + obj + b"%%EOF\n")
        images = _both("extract_pdf_images", path)
        assert len(images) == 1
        assert np.asarray(Image.open(io.BytesIO(images[0]))).tobytes() == raw


@pytest.mark.parametrize("head,key", [
    (b"<< /Width 32 /Height 16 >>", b"Width"),
    (b"<< /Width 5 0 R /Height 16 >>", b"Width"),
    (b"<< /Width 512 0 R >>", b"Width"),
    (b"<< /Width  77\n/Height 3 >>", b"Height"),
    (b"<< /BitsPerComponent 8 >>", b"Width"),
    (b"<< /Width 12 34 R >>", b"Width"),
])
def test_dict_int_refuses_indirect_references(head, key):
    _both("_dict_int", head, key)
    assert tpdf._dict_int(b"<< /Width 5 0 R >>", b"Width") == 0


def test_an_indirect_width_skips_its_image(tmp_path):
    raw = _seeded_rgb(4, 8, 8).tobytes()
    obj = _flate_obj(raw, 8, 8).replace(b"/Width 8", b"/Width 9 0 R")
    path = _write(tmp_path, "ind.pdf", b"%PDF-1.4\n" + obj + b"%%EOF\n")
    assert _both("extract_pdf_images", path) == []


def test_without_pil_flate_is_skipped_and_dct_passes(tmp_path, monkeypatch):
    jpeg = _jpeg(_seeded_rgb(5, 32, 32))
    body = (_image_obj(b"/Width 32 /Height 32 /Filter /DCTDecode", jpeg)
            + _flate_obj(_seeded_rgb(6).tobytes(), 24, 16))
    path = _write(tmp_path, "nopil.pdf", b"%PDF-1.4\n" + body + b"%%EOF\n")
    assert len(_both("extract_pdf_images", path)) == 2
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert _both("extract_pdf_images", path) == [jpeg]


# --------------------------------------------------------------------------- #
# whole documents and streams= reuse


def _document(rng):
    grid = [_words(rng, 5) for _ in range(12)]
    prose = [" ".join(_words(rng, 8)) + "." for _ in range(6)]
    chart = np.full((64, 96, 3), 255, np.uint8)
    chart[::8, :] = 20
    chart[:, ::12] = 20
    pages = [
        (tpdf.text_ops(prose), []),
        (tpdf.table_ops(grid), []),
        (b"", [("jpeg", _jpeg(chart), 96, 64)]),
        (tpdf.text_ops(["Figure 2."]), [("raw", _seeded_rgb(7, 16, 16).tobytes(), 16, 16, 3),
                                        ("raw", _seeded_rgb(8, 16, 8)[..., 0].tobytes(), 16, 8, 1)]),
    ]
    return tpdf.write_pdf(pages), prose, grid


@pytest.mark.parametrize("seed", range(3))
def test_a_written_document_reads_alike(tmp_path, seed):
    data, prose, grid = _document(np.random.RandomState(seed))
    path = _write(tmp_path, "doc.pdf", data)
    streams = list(tpdf.iter_content_streams(path))
    assert streams == list(jpdf.iter_content_streams(path))
    text = _both("extract_pdf_text", path)
    assert _both("extract_pdf_text", path, streams=streams) == text
    assert _both("extract_pdf_streams", path, streams=streams) == _both("extract_pdf_streams", path)
    assert text.startswith("\n".join(prose))
    tables = _both("extract_pdf_tables", path, streams=streams)
    assert tables == _both("extract_pdf_tables", path) == [grid]
    images = _both("extract_pdf_images", path)
    assert [b[:2] for b in images] == [b"\xff\xd8", b"\x89P", b"\x89P"]


def test_write_text_pdf_reads_back(tmp_path):
    lines = ["plain", "with (parens) and \\ slash", "last"]
    path = _write(tmp_path, "w.pdf", tpdf.write_text_pdf(lines))
    assert _both("extract_pdf_text", path) == "\n".join(lines)
    assert _both("extract_pdf_tables", path) == []


# --------------------------------------------------------------------------- #
# PPTX


def test_pptx_text_and_images(tmp_path):
    rng = np.random.RandomState(11)
    slides = [[" ".join(_words(rng, 4)) for _ in range(3)] for _ in range(11)]
    slides[4] = []  # a slide with no text is left out
    media = {"image2.png": b"\x89PNG fake", "image10.JPG": b"\xff\xd8 fake",
             "image1.jpeg": b"\xff\xd8 one", "movie.mp4": b"skip", "pic.gif": b"GIF8"}
    data = tpptx.write_pptx(slides, notes={2: ["a note & <more>"], 11: ["last note"]}, media=media)
    path = _write(tmp_path, "deck.pptx", data)
    text = _both("extract_pptx_text", path, mod=(jpptx, tpptx))
    blocks = text.split("\n\n")
    assert [b.splitlines()[0] for b in blocks] == [f"[slide {i}]" for i in range(1, 12) if i != 5]
    # notes are keyed by _slide_number, whose "slide(\d+)" does not match
    # "notesSlide2.xml": they never join a slide, in both packages
    assert "a note" not in text and "last note" not in text
    images = _both("extract_pptx_images", path, mod=(jpptx, tpptx))
    assert images == [media[n] for n in ("image1.jpeg", "image10.JPG", "image2.png", "pic.gif")]
    assert _both("extract_pptx_images", path, mod=(jpptx, tpptx), max_images=2) == images[:2]


def test_pptx_malformed_slide_and_not_a_zip(tmp_path):
    import zipfile

    path = tmp_path / "bad.pptx"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("ppt/slides/slide1.xml", "<not xml")
        zf.writestr("ppt/slides/slide2.xml",
                    '<p:sld xmlns:p="p" xmlns:a="http://schemas.openxmlformats.org/drawingml/'
                    '2006/main"><a:t> kept </a:t><a:t>  </a:t></p:sld>')
    assert _both("extract_pptx_text", str(path), mod=(jpptx, tpptx)) == "[slide 2]\nkept"
    junk = _write(tmp_path, "junk.pptx", b"not a zip")
    errors = []
    for mod in (jpptx, tpptx):
        with pytest.raises(zipfile.BadZipFile) as exc:
            mod.extract_pptx_text(junk)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
