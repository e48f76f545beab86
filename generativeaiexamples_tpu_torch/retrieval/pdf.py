"""PDF text extraction with the standard library only (``re``, ``zlib``).

The text half of the JAX package's generativeaiexamples_tpu/retrieval/pdf.py:
decompress FlateDecode content streams and walk the text operators (Tj,
TJ, ', ") between BT and ET, breaking lines on Td/TD/T* moves; lines
repeated across many pages are page furniture and are dropped. The table
and image extraction that only the multimodal chain uses are not ported.
``write_text_pdf`` writes the one-page PDF the tests and chip_smoke.py
ingest.
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


def extract_pdf_streams(path: str) -> List[str]:
    """Per-content-stream text (about one page each for most writers)."""
    return [t for t in map(_extract_stream_text, iter_content_streams(path)) if t]


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


def extract_pdf_text(path: str) -> str:
    """Best-effort text from every content stream, page furniture removed."""
    return "\n\n".join(strip_repeated_furniture(extract_pdf_streams(path)))


def write_text_pdf(lines: List[str]) -> bytes:
    """A one-page PDF whose FlateDecode content stream shows ``lines`` (one
    Tj each, a Td move between them); ``extract_pdf_text`` reads them back
    joined by newlines. Latin-1 text only; parentheses and backslashes
    are escaped."""
    shown = []
    for line in lines:
        esc = line.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
        shown.append(f"({esc}) Tj 0 -14 Td")
    content = ("BT /F1 12 Tf 72 720 Td " + " ".join(shown) + " ET").encode("latin-1")
    # the stream pattern drops one end-of-line byte before "endstream", so
    # the compressed body must not end in one (nor hold "endstream")
    body = next(b for b in (zlib.compress(content, level) for level in range(9, -1, -1))
                if not b.endswith((b"\r", b"\n")) and b"endstream" not in b)
    return (
        b"%PDF-1.4\n1 0 obj<</Type/Catalog/Pages 2 0 R>>endobj\n"
        b"2 0 obj<</Type/Pages/Kids[3 0 R]/Count 1>>endobj\n"
        b"3 0 obj<</Type/Page/Parent 2 0 R/Contents 4 0 R>>endobj\n"
        b"4 0 obj<</Length " + str(len(body)).encode() + b"/Filter/FlateDecode>>\n"
        b"stream\n" + body + b"\nendstream\nendobj\n%%EOF\n"
    )
