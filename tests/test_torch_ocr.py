"""The port's template OCR (generativeaiexamples_tpu_torch/retrieval/ocr.py)
against the JAX package's, on the CPU, at equality: strings from both, and
arrays bitwise (the atlas, the Otsu threshold, projection runs, glyph
masks, correlation scores).

The pages are those of tests/test_ocr.py (clean lines, scan noise, kerned
capitals), rendered once with the face the atlas uses. The optional
modules are also hidden through ``sys.modules``: without matplotlib both
atlases fall back to PIL's faces alike; without scipy ``recognize_array``
raises alike and ``recognize_image_bytes`` reads ""; without PIL the
bytes path reads "".
"""
import io
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

from generativeaiexamples_tpu.retrieval import ocr as jocr
from generativeaiexamples_tpu_torch.retrieval import ocr as tocr

PAGES = {
    "clean": ["The quick brown fox", "jumps over 42 lazy dogs.",
              "Retrieval Augmented Generation (RAG) example."],
    "kerned": ["RAVE minimum wavelength"],
    "noisy": ["Noisy scanned page text"],
}


def _render(mod, text_lines, size=32, width=1100):
    font = mod._find_font(size)
    img = Image.new("L", (width, 40 + 60 * len(text_lines)), 255)
    d = ImageDraw.Draw(img)
    for i, line in enumerate(text_lines):
        d.text((20, 20 + 60 * i), line, fill=0, font=font)
    return np.asarray(img)


def _page(name, mod=tocr):
    arr = _render(mod, PAGES[name])
    if name == "noisy":
        rng = np.random.default_rng(0)
        arr = np.clip(arr.astype(np.float32) + rng.normal(0.0, 18.0, arr.shape), 0, 255)
    return arr


@pytest.fixture
def fresh_atlas(monkeypatch):
    """Each package builds its atlas anew (and drops it after)."""
    monkeypatch.setattr(jocr, "_ATLAS", None)
    monkeypatch.setattr(tocr, "_ATLAS", None)


def _same_atlas():
    ja, ta = jocr._atlas(), tocr._atlas()
    assert [t.char for t in ta] == [t.char for t in ja]
    for j, t in zip(ja, ta):
        assert t.vec.dtype == j.vec.dtype and np.array_equal(t.vec, j.vec)
        assert (t.top_rel, t.h_rel) == (j.top_rel, j.h_rel)
    return ta


def test_the_atlases_are_bitwise_equal(fresh_atlas):
    atlas = _same_atlas()
    assert len(atlas) == len(tocr._CHARS)


@pytest.mark.parametrize("name", sorted(PAGES))
def test_pages_read_alike(name):
    arr = _page(name)
    got = tocr.recognize_array(arr)
    assert got == jocr.recognize_array(arr)
    want = "\n".join(PAGES[name])
    assert got == want  # as tests/test_ocr.py reads them


@pytest.mark.parametrize("name", sorted(PAGES))
def test_image_bytes_read_alike(name):
    buf = io.BytesIO()
    Image.fromarray(_page(name).astype(np.uint8)).save(buf, format="PNG")
    data = buf.getvalue()
    assert tocr.recognize_image_bytes(data) == jocr.recognize_image_bytes(data)


def test_undecodable_bytes_and_a_photograph_read_empty():
    assert tocr.recognize_image_bytes(b"not an image") == jocr.recognize_image_bytes(
        b"not an image") == ""
    photo = np.random.RandomState(3).randint(0, 256, (120, 160, 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(photo).save(buf, format="PNG")
    assert tocr.recognize_image_bytes(buf.getvalue()) == jocr.recognize_image_bytes(
        buf.getvalue())
    assert tocr.recognize_array(photo) == jocr.recognize_array(photo)
    blank = np.full((40, 60), 255, np.uint8)
    assert tocr.recognize_array(blank) == jocr.recognize_array(blank) == ""


@pytest.mark.parametrize("seed", range(5))
def test_otsu_threshold(seed):
    rng = np.random.RandomState(seed)
    gray = np.concatenate([rng.normal(60, 20, 500), rng.normal(200, 15, 1500)])
    gray = np.clip(gray, 0, 255).astype(np.uint8).reshape(40, 50)
    assert tocr._otsu_threshold(gray) == jocr._otsu_threshold(gray)
    flat = np.full((8, 8), seed * 40, np.uint8)
    assert tocr._otsu_threshold(flat) == jocr._otsu_threshold(flat)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("min_gap", [1, 2, 3])
def test_projection_runs(seed, min_gap):
    profile = np.random.RandomState(seed).rand(200) < 0.4
    assert tocr._runs(profile, min_gap) == jocr._runs(profile, min_gap)
    assert tocr._runs(np.zeros(9, bool), min_gap) == jocr._runs(np.zeros(9, bool), min_gap) == []


@pytest.mark.parametrize("name", sorted(PAGES))
def test_glyph_segmentation_and_scores(name):
    """Every line's glyphs (spans and masks bitwise) and every glyph's
    best match and score, as ``recognize_array`` computes them."""
    gray = _page(name).astype(np.float32)
    ink = gray < tocr._otsu_threshold(gray.astype(np.uint8))
    atlas = tocr._atlas()
    for ly0, ly1 in tocr._runs(ink.sum(axis=1) > 0, min_gap=1):
        band = ink[ly0:ly1]
        got, want = tocr._segment_glyphs(band), jocr._segment_glyphs(band)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:4] == w[:4] and np.array_equal(g[4], w[4])
        if not got:
            continue
        baseline = int(np.percentile([g[3] for g in got], 80))
        line_top = int(min(g[2] for g in got))
        for x0, x1, top, bottom, mask in got:
            m = mask.astype(np.float32)
            t = tocr._recognize_maybe_split(m, line_top, baseline, top, bottom, atlas)
            j = jocr._recognize_maybe_split(m, line_top, baseline, top, bottom, jocr._atlas())
            assert t == j
            assert tocr._recognize_glyph(m, line_top, baseline, top, bottom, atlas) == \
                jocr._recognize_glyph(m, line_top, baseline, top, bottom, jocr._atlas())


@pytest.mark.parametrize("seed", range(3))
def test_normalize_glyph(seed):
    glyph = (np.random.RandomState(seed).rand(17 + seed, 9 + 3 * seed) > 0.5).astype(np.float32)
    assert np.array_equal(tocr._normalize_glyph(glyph), jocr._normalize_glyph(glyph))


def test_without_matplotlib_both_fall_back_alike(fresh_atlas, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _same_atlas()
    arr = _render(tocr, PAGES["clean"])
    assert np.array_equal(arr, _render(jocr, PAGES["clean"]))
    assert tocr.recognize_array(arr) == jocr.recognize_array(arr)


def test_without_scipy_both_fail_alike(monkeypatch):
    arr = _page("kerned")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    monkeypatch.setitem(sys.modules, "scipy", None)
    errors = []
    for mod in (jocr, tocr):
        with pytest.raises(ImportError) as exc:
            mod.recognize_array(arr)
        errors.append((type(exc.value), str(exc.value)))
        assert mod.recognize_image_bytes(buf.getvalue()) == ""
    assert errors[0] == errors[1]


def test_without_pil_the_bytes_path_reads_empty(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(_page("kerned")).save(buf, format="PNG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tocr.recognize_image_bytes(buf.getvalue()) == jocr.recognize_image_bytes(
        buf.getvalue()) == ""
