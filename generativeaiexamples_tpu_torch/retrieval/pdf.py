"""PDF text, table and image extraction with the standard library (``re``,
``zlib``; PIL only to re-encode FlateDecode bitmaps).

The port's copy of the JAX package's generativeaiexamples_tpu/retrieval/pdf.py:
decompress FlateDecode content streams and walk the text operators (Tj,
TJ, ', ") between BT and ET, breaking lines on Td/TD/T* moves; lines
repeated across many pages are page furniture and are dropped.
Positioned text (Tm/Td/TD/T*) feeds ``extract_pdf_tables``, which finds
runs of rows whose cells start at the same x columns; raster image
XObjects come out of ``extract_pdf_images`` (DCTDecode as the JPEG it is,
FlateDecode bitmaps re-encoded to PNG through PIL) for the multimodal
chain. ``write_text_pdf`` and ``write_pdf`` write the PDFs the tests and
chip_smoke.py ingest.
"""
from __future__ import annotations

import re
import zlib
from collections import Counter
from typing import List

_STREAM_RE = re.compile(rb"stream\r?\n(.*?)(?:\r?\n)?endstream", re.DOTALL)
_ESCAPES = {0x6E: 0x0A, 0x72: 0x0D, 0x74: 0x09, 0x62: 0x08, 0x66: 0x0C}


def _decode_pdf_string(raw: bytes) -> str:
    """Decode a PDF literal string body (escapes handled)."""
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == 0x5C and i + 1 < len(raw):  # backslash
            nxt = raw[i + 1]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                i += 2
            elif nxt in (0x28, 0x29, 0x5C):
                out.append(nxt)
                i += 2
            elif 0x30 <= nxt <= 0x37:  # octal escape
                j = i + 1
                digits = b""
                while j < len(raw) and len(digits) < 3 and 0x30 <= raw[j] <= 0x37:
                    digits += bytes([raw[j]])
                    j += 1
                out.append(int(digits, 8) & 0xFF)
                i = j
            else:
                i += 2
        else:
            out.append(c)
            i += 1
    try:
        if out.startswith(b"\xfe\xff"):
            return out[2:].decode("utf-16-be", errors="replace")
        return out.decode("utf-8")
    except UnicodeDecodeError:
        return out.decode("latin-1", errors="replace")


def _iter_strings(token: bytes) -> List[str]:
    """Pull literal (...) and hex <...> strings out of an operand run."""
    parts: List[str] = []
    depth = 0
    buf = bytearray()
    i = 0
    while i < len(token):
        c = token[i]
        if depth == 0 and c == 0x28:  # (
            depth = 1
            buf = bytearray()
        elif depth > 0:
            if c == 0x5C and i + 1 < len(token):
                buf += token[i : i + 2]
                i += 2
                continue
            if c == 0x28:
                depth += 1
                buf.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    parts.append(_decode_pdf_string(bytes(buf)))
                else:
                    buf.append(c)
            else:
                buf.append(c)
        elif c == 0x3C:  # < hex string
            end = token.find(b">", i)
            if end > i:
                hexbody = re.sub(rb"\s", b"", token[i + 1 : end])
                if len(hexbody) % 2:
                    hexbody += b"0"
                try:
                    raw = bytes.fromhex(hexbody.decode("ascii"))
                    if raw.startswith(b"\xfe\xff"):
                        parts.append(raw[2:].decode("utf-16-be", errors="replace"))
                    elif len(raw) >= 2 and raw[0] == 0:
                        # crude UTF-16BE detection for CID fonts
                        parts.append(raw.decode("utf-16-be", errors="replace"))
                    else:
                        parts.append(raw.decode("latin-1", errors="replace"))
                except ValueError:
                    pass
                i = end
        i += 1
    return parts


_TEXT_OP_RE = re.compile(
    rb"((?:\((?:\\.|[^\\()])*\)|<[0-9A-Fa-f\s]*>|[^()<>])*?)\s*(Tj|TJ|T\*|Td|TD|'|\")",
    re.DOTALL,
)


def _extract_stream_text(data: bytes) -> str:
    lines: List[str] = []
    current: List[str] = []
    for block in re.findall(rb"BT(.*?)ET", data, re.DOTALL):
        for operands, op in _TEXT_OP_RE.findall(block):
            if op in (b"Tj", b"TJ", b"'", b'"'):
                current.extend(_iter_strings(operands))
                if op in (b"'", b'"') and current:
                    lines.append("".join(current))
                    current = []
            elif op in (b"T*", b"Td", b"TD"):
                if current:
                    lines.append("".join(current))
                    current = []
        if current:
            lines.append("".join(current))
            current = []
    return "\n".join(line for line in lines if line.strip())


def iter_content_streams(path: str):
    """Each stream object's text-bearing bytes, the decompressed form first
    (compressed bytes can happen to hold a 'BT'/'ET' pair)."""
    with open(path, "rb") as fh:
        data = fh.read()
    for match in _STREAM_RE.finditer(data):
        raw = match.group(1)
        candidates = [raw]
        try:
            candidates.insert(0, zlib.decompress(raw))
        except zlib.error:
            try:  # some writers pad the stream; try skipping whitespace
                candidates.insert(0, zlib.decompress(raw.lstrip(b"\r\n")))
            except zlib.error:
                pass
        for cand in candidates:
            if b"BT" in cand and b"ET" in cand:
                yield cand
                break


def extract_pdf_streams(path: str, streams=None) -> List[str]:
    """Per-content-stream text (about one page each for most writers).
    ``streams``: ``list(iter_content_streams(path))`` already made, so a
    caller that also extracts tables decompresses each stream once."""
    cands = streams if streams is not None else iter_content_streams(path)
    return [t for t in map(_extract_stream_text, cands) if t]


def strip_repeated_furniture(pages: List[str], threshold: float = 0.6) -> List[str]:
    """Drop header and footer lines repeated across pages: with 5 or more
    streams, a line on at least max(4, threshold x pages) of them."""
    if len(pages) < 5:
        return pages
    counts: Counter = Counter()
    for page in pages:
        for line in {ln.strip() for ln in page.splitlines() if ln.strip()}:
            counts[line] += 1
    cutoff = max(4, int(len(pages) * threshold))
    furniture = {line for line, n in counts.items() if n >= cutoff}
    return [
        "\n".join(ln for ln in page.splitlines() if ln.strip() not in furniture)
        for page in pages
    ]


def extract_pdf_text(path: str, streams=None) -> str:
    """Best-effort text from every content stream, page furniture removed."""
    return "\n\n".join(strip_repeated_furniture(extract_pdf_streams(path, streams)))


# --------------------------------------------------------------------- #
# Positioned text and tables: positions come from the content stream's
# text-positioning operators (Tm/Td/TD/T*), and a table is a run of
# consecutive rows whose cells start at the same x columns.

_TOKEN_RE = re.compile(
    rb"\((?:\\.|[^\\()])*\)"  # literal string
    rb"|<[0-9A-Fa-f\s]*>"  # hex string
    rb"|\[(?:\((?:\\.|[^\\()])*\)|[^\]])*\]"  # array (TJ operand)
    rb"|[-+]?[0-9]*\.?[0-9]+"  # number
    rb"|/[^\s\[\]()<>/]+"  # name
    rb"|[A-Za-z'\"*]+"  # operator
)


def _extract_stream_runs(data: bytes):
    """Positioned show-text runs [(x, y, text)] from one content stream."""
    runs = []
    for block in re.findall(rb"BT(.*?)ET", data, re.DOTALL):
        line_x = line_y = 0.0
        cur_x = cur_y = 0.0
        leading = 12.0
        operands: List[bytes] = []
        for m in _TOKEN_RE.finditer(block):
            tok = m.group(0)
            first = tok[:1]
            if first in b"(<[" or first.isdigit() or first in b"-+." or first == b"/":
                operands.append(tok)
                continue
            op = tok

            def nums(n):
                vals = []
                for t in operands[-n:]:
                    try:
                        vals.append(float(t))
                    except ValueError:
                        vals.append(0.0)
                return vals if len(vals) == n else [0.0] * n

            if op == b"Tm" and len(operands) >= 6:
                _, _, _, _, e, f = nums(6)
                line_x = cur_x = e
                line_y = cur_y = f
            elif op in (b"Td", b"TD") and len(operands) >= 2:
                tx, ty = nums(2)
                line_x += tx
                line_y += ty
                cur_x, cur_y = line_x, line_y
                if op == b"TD":
                    leading = -ty if ty else leading
            elif op == b"TL" and operands:
                (leading,) = nums(1)
            elif op == b"T*":
                line_y -= leading
                cur_x, cur_y = line_x, line_y
            elif op in (b"Tj", b"TJ", b"'", b'"'):
                if op in (b"'", b'"'):
                    line_y -= leading
                    cur_x, cur_y = line_x, line_y
                text = "".join(_iter_strings(b" ".join(operands)))
                if text.strip():
                    runs.append((cur_x, cur_y, text))
            operands = []
    return runs


def _runs_to_rows(runs, y_tol: float = 2.0):
    """Cluster runs into rows by y (descending page order), cells by x."""
    rows: List[List] = []
    for x, y, text in sorted(runs, key=lambda r: (-r[1], r[0])):
        if rows and abs(rows[-1][0][1] - y) <= y_tol:
            rows[-1].append((x, y, text))
        else:
            rows.append([(x, y, text)])
    return [sorted(row, key=lambda r: r[0]) for row in rows]


def _columns_match(a, b, x_tol: float = 3.0) -> bool:
    if len(a) != len(b) or len(a) < 2:
        return False
    return all(abs(xa - xb) <= x_tol for xa, xb in zip(a, b))


def extract_pdf_tables(path: str, streams=None) -> List[List[List[str]]]:
    """Tables as row-major cell grids: a table is 2 or more consecutive
    rows of 2 or more cells whose x origins line up (within 3 units)."""
    tables: List[List[List[str]]] = []
    for cand in streams if streams is not None else iter_content_streams(path):
        rows = _runs_to_rows(_extract_stream_runs(cand))
        current: List[List[str]] = []
        cols: List[float] = []
        for row in rows:
            xs = [r[0] for r in row]
            if _columns_match(cols, xs):
                current.append([r[2].strip() for r in row])
            else:
                if len(current) >= 2:
                    tables.append(current)
                current = [[r[2].strip() for r in row]] if len(row) >= 2 else []
                cols = xs if len(row) >= 2 else []
        if len(current) >= 2:
            tables.append(current)
    return tables


def stringify_table(table: List[List[str]]) -> str:
    """Pipe-separated rows: the text a table chunk carries."""
    return "\n".join(" | ".join(row) for row in table)


_IMAGE_DICT_RE = re.compile(
    rb"<<(?:[^<>]|<<[^<>]*>>)*?/Subtype\s*/Image(?:[^<>]|<<[^<>]*>>)*?>>\s*stream\r?\n",
    re.DOTALL,
)


def _dict_int(d: bytes, key: bytes) -> int:
    # an indirect reference ("/Width 5 0 R" is object 5, not 5) reads as
    # 0, so its image is skipped; \b pins the whole digit run so
    # backtracking cannot shorten it past the lookahead
    m = re.search(rb"/" + key + rb"\s+(\d+)\b(?!\s+\d+\s+R)", d)
    return int(m.group(1)) if m else 0


def extract_pdf_images(path: str, max_images: int = 32) -> List[bytes]:
    """Embedded raster images as encoded bytes: a DCTDecode XObject is a
    JPEG (returned as it is), a FlateDecode Gray/RGB/CMYK bitmap of 8 bits
    a component is re-encoded to PNG through PIL (skipped without PIL);
    other encodings are skipped."""
    with open(path, "rb") as fh:
        data = fh.read()
    images: List[bytes] = []
    for m in _IMAGE_DICT_RE.finditer(data):
        if len(images) >= max_images:
            break
        head = m.group(0)
        start = m.end()
        end = data.find(b"endstream", start)
        if end < 0:
            continue
        # a PDF puts at most ONE end-of-line before 'endstream': strip
        # exactly one (rstrip would eat 0x0a/0x0d bytes of the zlib body)
        body = data[start:end]
        if body.endswith(b"\r\n"):
            body = body[:-2]
        elif body.endswith((b"\n", b"\r")):
            body = body[:-1]
        if b"/DCTDecode" in head:
            if body.startswith(b"\xff\xd8"):
                images.append(body)  # raw JPEG
            continue
        if b"/FlateDecode" in head:
            try:
                raw = zlib.decompress(body)
            except zlib.error:
                continue
            w, h = _dict_int(head, b"Width"), _dict_int(head, b"Height")
            bpc = _dict_int(head, b"BitsPerComponent") or 8
            if not w or not h or bpc != 8:
                continue
            comps = len(raw) // (w * h) if w * h else 0
            mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(comps)
            if mode is None or len(raw) < w * h * comps:
                continue
            try:
                from io import BytesIO

                from PIL import Image

                img = Image.frombytes(mode, (w, h), raw[: w * h * comps])
                buf = BytesIO()
                img.convert("RGB").save(buf, format="PNG")
                images.append(buf.getvalue())
            except Exception:  # noqa: BLE001 - malformed bitmap, or no PIL: skip
                continue
    return images


def _compressed(content: bytes) -> bytes:
    """``content`` deflated at the highest level whose output neither ends
    in an end-of-line byte (the stream pattern drops one before
    "endstream") nor holds "endstream". The output ends in the content's
    adler32, the same at every level, so where no level fits, the content
    takes a trailing space (whitespace to a content stream's parser) and
    is tried again."""
    for pad in range(64):
        padded = content + b" " * pad
        for level in range(9, -1, -1):
            body = zlib.compress(padded, level)
            if not body.endswith((b"\r", b"\n")) and b"endstream" not in body:
                return body
    raise ValueError("no deflated form of the content fits a PDF stream")


def _pdf_string(text: str) -> str:
    return "(" + text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)") + ")"


def text_ops(lines: List[str], x: float = 72, y: float = 720, leading: float = 14) -> bytes:
    """One BT block showing ``lines`` from (x, y) down, a Td move between
    them (``extract_pdf_text`` reads them back joined by newlines)."""
    shown = " 0 -{} Td ".format(leading).join(f"{_pdf_string(line)} Tj" for line in lines)
    return f"BT /F1 12 Tf {x} {y} Td {shown} ET".encode("latin-1")


def table_ops(rows: List[List[str]], x: float = 72, y: float = 700, col_width: float = 96,
              row_height: float = 18) -> bytes:
    """One BT block placing each cell of ``rows`` at its column's x origin
    (``extract_pdf_tables`` reads them back as one table)."""
    ops = [f"1 0 0 1 {x + c * col_width} {y - r * row_height} Tm {_pdf_string(cell)} Tj"
           for r, row in enumerate(rows) for c, cell in enumerate(row)]
    return ("BT /F1 10 Tf " + " ".join(ops) + " ET").encode("latin-1")


def write_pdf(pages: List[tuple]) -> bytes:
    """A PDF of one page per entry of ``pages``: ``(content, images)``,
    ``content`` the page's content operators (``text_ops``, ``table_ops``
    or b"") and ``images`` its image XObjects, each ``("jpeg", bytes,
    width, height)`` (DCTDecode, RGB) or ``("raw", pixels, width, height,
    components)`` (FlateDecode, 8 bits a component, 1 or 3 components). A
    page that shows images draws each with ``Do``."""
    objs: List[bytes] = []  # object k + 1

    def add(body: bytes) -> int:
        objs.append(body)
        return len(objs)

    catalog = add(b"")
    pages_obj = add(b"")
    kids = []
    for content, images in pages:
        names = []
        for i, image in enumerate(images):
            if image[0] == "jpeg":
                _, data, w, h = image
                space, codec = "/DeviceRGB", "/DCTDecode"
            else:
                _, pixels, w, h, comps = image
                data = zlib.compress(pixels)
                space, codec = ("/DeviceGray" if comps == 1 else "/DeviceRGB"), "/FlateDecode"
            head = (f"<</Type/XObject/Subtype/Image/Width {w}/Height {h}/ColorSpace{space}"
                    f"/BitsPerComponent 8/Filter{codec}/Length {len(data)}>>")
            ref = add(head.encode() + b"\nstream\n" + data + b"\nendstream")
            names.append((f"Im{i}", ref, w, h))
        draws = b" ".join(f"q {w} 0 0 {h} 72 {100 + 10 * i} cm /{n} Do Q".encode()
                          for i, (n, _, w, h) in enumerate(names))
        body = _compressed(content + (b" " + draws if draws else b""))
        stream = add(b"<</Length " + str(len(body)).encode() + b"/Filter/FlateDecode>>\n"
                     b"stream\n" + body + b"\nendstream")
        xobjects = "".join(f"/{n} {ref} 0 R" for n, ref, _, _ in names)
        kids.append(add(f"<</Type/Page/Parent {pages_obj} 0 R/Resources<</XObject<<{xobjects}"
                        f">>>>/Contents {stream} 0 R>>".encode()))
    objs[catalog - 1] = f"<</Type/Catalog/Pages {pages_obj} 0 R>>".encode()
    objs[pages_obj - 1] = (f"<</Type/Pages/Kids[{' '.join(f'{k} 0 R' for k in kids)}]"
                           f"/Count {len(kids)}>>").encode()
    out = b"%PDF-1.4\n"
    for k, body in enumerate(objs, 1):
        out += f"{k} 0 obj".encode() + body + b"\nendobj\n"
    return out + b"%%EOF\n"


def write_text_pdf(lines: List[str]) -> bytes:
    """A one-page PDF showing ``lines`` (``text_ops``); ``extract_pdf_text``
    reads them back joined by newlines. Latin-1 text only."""
    return write_pdf([(text_ops(lines), [])])
