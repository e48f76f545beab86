"""Template-matching OCR for scanned pages, in numpy: the port's copy of
the JAX package's generativeaiexamples_tpu/retrieval/ocr.py, for machines
without pytesseract.

1. binarize (Otsu) and cut the page into ink lines by horizontal
   projection;
2. cut each line into glyphs by connected components (``scipy.ndimage``);
   components whose spans overlap almost wholly (the dot of an ``i``,
   both bars of ``=``) stay one glyph, and wide gaps become spaces;
3. read each glyph by normalized correlation against an atlas of
   templates rasterized through PIL from DejaVu Sans (matplotlib's copy,
   else PIL's faces), plus line-relative vertical-extent features that
   tell ``o`` from ``O`` and ``.`` from ``'``; a glyph that reads better
   split at its thinnest column (kerned capitals that touch) is split.

A page whose glyphs match at a mean score under 0.62 (a photograph, noise)
reads as "". Host code: nothing here touches a device, as in the JAX
package. The multimodal chain calls it through ``ocr_image_local``
(chains/multimodal.py).
"""
from __future__ import annotations

import dataclasses
import io
import logging
import string
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# Glyph bitmap normalization: max dimension scales to _GLYPH (aspect
# preserved), centered on a _CANVAS-square canvas.
_GLYPH = 24
_CANVAS = 28
_CHARS = string.ascii_letters + string.digits + ".,:;!?'()[]-+=/%&*#@$_<>"


@dataclasses.dataclass(frozen=True)
class _Template:
    char: str
    vec: np.ndarray  # [_CANVAS * _CANVAS] L2-normalized float32
    top_rel: float  # glyph top relative to the face ascent
    h_rel: float  # glyph height relative to the face ascent


def _find_font(size: int):
    """A packaged TrueType face: DejaVu Sans (matplotlib vendors it),
    else PIL's bundled default."""
    from PIL import ImageFont

    try:
        from matplotlib import font_manager

        return ImageFont.truetype(font_manager.findfont("DejaVu Sans"), size)
    except Exception:  # noqa: BLE001 - matplotlib optional
        try:
            return ImageFont.truetype("DejaVuSans.ttf", size)
        except Exception:  # noqa: BLE001
            return ImageFont.load_default(size)


def _normalize_glyph(glyph: np.ndarray) -> np.ndarray:
    """Scale a cropped ink bitmap to the canonical canvas and L2-norm."""
    from PIL import Image

    h, w = glyph.shape
    scale = _GLYPH / max(h, w)
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    img = Image.fromarray((glyph * 255).astype(np.uint8)).resize(
        (nw, nh), Image.BILINEAR
    )
    canvas = np.zeros((_CANVAS, _CANVAS), np.float32)
    y0 = (_CANVAS - nh) // 2
    x0 = (_CANVAS - nw) // 2
    canvas[y0 : y0 + nh, x0 : x0 + nw] = np.asarray(img, np.float32) / 255.0
    vec = canvas.reshape(-1)
    n = float(np.linalg.norm(vec))
    return vec / n if n > 0 else vec


_ATLAS: Optional[List[_Template]] = None


def _atlas() -> List[_Template]:
    """Rasterize the char set once per process (lazy — PIL import cost
    and ~70 tiny renders)."""
    global _ATLAS
    if _ATLAS is not None:
        return _ATLAS
    from PIL import Image, ImageDraw

    size = 48
    font = _find_font(size)
    try:
        ascent, _descent = font.getmetrics()
    except Exception:  # noqa: BLE001 - bitmap default font
        ascent = size
    pad = size

    def render(ch):
        img = Image.new("L", (3 * size, 3 * size), 0)
        ImageDraw.Draw(img).text((pad, pad), ch, fill=255, font=font)
        arr = np.asarray(img)
        ys, xs = np.nonzero(arr > 64)
        if ys.size == 0:
            return None
        return arr, int(ys.min()), int(ys.max()) + 1, int(xs.min()), int(xs.max()) + 1

    # The scan-side vertical origin is the LINE TOP (minimum ink row ==
    # cap/ascender top) and its unit is cap-top..baseline — so express
    # template metrics the same way: cap top from 'T', baseline from
    # the font metrics (drawing origin + ascent).
    t_ref = render("T")
    cap_top = t_ref[1] if t_ref is not None else pad
    ref_h = max(1, (pad + ascent) - cap_top)  # cap top -> baseline
    out: List[_Template] = []
    for ch in _CHARS:
        r = render(ch)
        if r is None:
            continue
        arr, y0, y1, x0, x1 = r
        glyph = (arr[y0:y1, x0:x1] > 64).astype(np.float32)
        out.append(
            _Template(
                char=ch,
                vec=_normalize_glyph(glyph),
                top_rel=(y0 - cap_top) / ref_h,
                h_rel=(y1 - y0) / ref_h,
            )
        )
    _ATLAS = out
    return out


def _otsu_threshold(gray: np.ndarray) -> float:
    hist, _ = np.histogram(gray, bins=256, range=(0, 256))
    total = gray.size
    csum = np.cumsum(hist)
    cmean = np.cumsum(hist * np.arange(256))
    mean_total = cmean[-1] / total
    w0 = csum / total
    w1 = 1.0 - w0
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = cmean / csum
        mu1 = (cmean[-1] - cmean) / (total - csum)
    var_between = w0 * w1 * (mu0 - mu1) ** 2
    var_between = np.nan_to_num(var_between)
    return float(np.argmax(var_between))


def _runs(profile: np.ndarray, min_gap: int = 1) -> List[Tuple[int, int]]:
    """[start, end) runs of truthy entries, merging gaps < min_gap."""
    idx = np.nonzero(profile)[0]
    if idx.size == 0:
        return []
    runs = []
    start = prev = int(idx[0])
    for i in idx[1:]:
        i = int(i)
        if i - prev >= min_gap + 1:
            runs.append((start, prev + 1))
            start = i
        prev = i
    runs.append((start, prev + 1))
    return runs


def _recognize_glyph(
    glyph: np.ndarray, line_top: int, baseline: int, y0: int, y1: int,
    atlas: Sequence[_Template],
) -> Tuple[str, float]:
    """Best-matching char + its score: bitmap correlation +
    vertical-extent prior."""
    ascent_est = max(1, baseline - line_top)
    top_rel = (y0 - line_top) / ascent_est
    h_rel = (y1 - y0) / ascent_est
    vec = _normalize_glyph(glyph)
    best_char, best_score = "", -np.inf
    for t in atlas:
        corr = float(np.dot(vec, t.vec))
        # vertical-extent prior with a deadband: sub-5% offsets are
        # rasterization noise (they were flipping i -> I), while the
        # case pairs this prior exists for (o/O, c/C) differ by ~25%
        dt = max(0.0, abs(top_rel - t.top_rel) - 0.05)
        dh = max(0.0, abs(h_rel - t.h_rel) - 0.05)
        score = corr - 0.4 * dt - 0.4 * dh
        if score > best_score:
            best_char, best_score = t.char, score
    return best_char, best_score


def _recognize_maybe_split(
    mask: np.ndarray, line_top: int, baseline: int, y0: int, y1: int,
    atlas: Sequence[_Template], depth: int = 0,
) -> Tuple[str, float]:
    """Recognize a glyph, splitting TOUCHING letter pairs when that
    reads better.

    Kerned capital pairs can fuse into one connected component (an
    ``R`` leg touching the ``A`` lean — observed as ``RA`` -> ``M``);
    the bridge is a thin ink valley, so try the split at the weakest
    interior column and keep it only when the halves' mean match score
    beats the whole — ``m``/``w`` are wide but match themselves better
    than any split, so they survive intact."""
    char, score = _recognize_glyph(mask, line_top, baseline, y0, y1, atlas)
    h, w = mask.shape
    if depth >= 3 or w < max(10, int(1.25 * h)):
        return char, score
    col_ink = mask.sum(axis=0)
    lo, hi = int(0.3 * w), int(0.7 * w)
    if hi <= lo:
        return char, score
    split = lo + int(np.argmin(col_ink[lo:hi]))
    parts = []
    for m, off in ((mask[:, :split], 0), (mask[:, split:], split)):
        ys, xs = np.nonzero(m)
        if ys.size < 2:
            return char, score
        sub = m[ys.min() : ys.max() + 1, xs.min() : xs.max() + 1]
        parts.append(
            _recognize_maybe_split(
                sub, line_top, baseline,
                y0 + int(ys.min()), y0 + int(ys.max()) + 1,
                atlas, depth + 1,
            )
        )
    mean_split = sum(s for _, s in parts) / len(parts)
    if mean_split > score + 0.02:
        return "".join(c for c, _ in parts), mean_split
    return char, score


def recognize_array(gray: np.ndarray) -> str:
    """OCR a grayscale page array ([H, W] uint8, dark ink on light)."""
    if gray.ndim == 3:
        gray = gray.mean(axis=-1)
    gray = gray.astype(np.float32)
    if gray.max() <= 1.0:
        gray = gray * 255.0
    thr = _otsu_threshold(gray.astype(np.uint8))
    ink = gray < thr  # dark-on-light
    if ink.mean() > 0.5:  # inverted page (light-on-dark)
        ink = ~ink
    if not ink.any():
        return ""
    atlas = _atlas()
    lines_out: List[str] = []
    scores: List[float] = []
    row_profile = ink.sum(axis=1)
    # merge sub-pixel gaps (dot of an i against its line) by allowing
    # 1-row holes inside a line band
    for ly0, ly1 in _runs(row_profile > 0, min_gap=1):
        band = ink[ly0:ly1]
        if ly1 - ly0 < 4:  # speckle
            continue
        glyphs = _segment_glyphs(band)
        if not glyphs:
            continue
        # line metrics: baseline at the 80th percentile of glyph
        # bottoms (robust against descenders), top at the min ink row
        tops = [g[2] for g in glyphs]
        bottoms = [g[3] for g in glyphs]
        baseline = int(np.percentile(bottoms, 80))
        line_top = int(min(tops))
        line_h = max(1, ly1 - ly0)
        space_gap = max(2.0, 0.30 * line_h)
        chars: List[str] = []
        prev_end = None
        for (gx0, gx1, top, bottom, mask) in glyphs:
            if prev_end is not None and gx0 - prev_end > space_gap:
                chars.append(" ")
            prev_end = gx1
            if mask.size == 0 or not mask.any():
                continue
            ch, score = _recognize_maybe_split(
                mask.astype(np.float32), line_top, baseline, top,
                bottom, atlas,
            )
            chars.append(ch)
            scores.append(score)
        line = "".join(chars).strip()
        if line:
            lines_out.append(line)
    # Confidence gate: real rendered text matches templates at ~0.75+
    # mean score; binarized photograph/noise blobs land ~0.5. Emitting
    # those as "text" would poison the caption pathway (GraphFlow only
    # falls through to VLM/heuristic captions when OCR returns "").
    if not scores or len(scores) < 2 or float(np.mean(scores)) < 0.62:
        return ""
    return "\n".join(lines_out)


def _segment_glyphs(band: np.ndarray):
    """Connected-component glyph segmentation for one line band.

    Column projection cannot split KERNED pairs (a ``V`` tucked against
    a ``K`` shares columns, and the merged run reads as one garbage
    glyph); components can — each glyph keeps only ITS labeled pixels,
    so a neighbor's overhang inside the bounding box is excluded.
    Components whose horizontal spans overlap by >= 0.85 of the narrower
    width merge back into one glyph (the dot of an ``i``, both bars of
    ``=``, the dots of ``:`` — all near-total overlaps), while kerned
    letter pairs (partial overlap) stay separate.

    Returns [(x0, x1, top, bottom, mask)] in reading order.
    """
    from scipy import ndimage

    labels, n = ndimage.label(band)
    if not n:
        return []
    comps = []
    for i, sl in enumerate(ndimage.find_objects(labels)):
        if sl is None:
            continue
        ys, xs = sl
        if (labels[sl] == i + 1).sum() < 2:  # speckle
            continue
        comps.append((xs.start, xs.stop, ys.start, ys.stop, i + 1))
    comps.sort(key=lambda c: (c[0] + c[1]))
    groups: List[List[tuple]] = []
    for c in comps:
        if groups:
            gx0 = min(m[0] for m in groups[-1])
            gx1 = max(m[1] for m in groups[-1])
            overlap = min(gx1, c[1]) - max(gx0, c[0])
            if overlap >= 0.85 * min(gx1 - gx0, c[1] - c[0]):
                groups[-1].append(c)
                continue
        groups.append([c])
    out = []
    for g in groups:
        x0 = min(m[0] for m in g)
        x1 = max(m[1] for m in g)
        y0 = min(m[2] for m in g)
        y1 = max(m[3] for m in g)
        ids = {m[4] for m in g}
        mask = np.isin(labels[y0:y1, x0:x1], list(ids))
        out.append((x0, x1, y0, y1, mask))
    out.sort(key=lambda t: t[0])
    return out


def recognize_image_bytes(image_bytes: bytes) -> str:
    """OCR an encoded image (png/jpeg/...). Best-effort: undecodable
    input returns ""."""
    try:
        from PIL import Image

        img = Image.open(io.BytesIO(image_bytes)).convert("L")
        return recognize_array(np.asarray(img))
    except Exception as exc:  # noqa: BLE001 - OCR is best-effort
        logger.warning("pure-python OCR failed: %s", exc)
        return ""
