"""multipart/form-data bodies over the standard library's email parser:
:func:`parts` reads the fields of one in order (the O-RAN chatbot's
upload), :func:`file_field` its ``file`` field (the chain server's and
the frontend's uploads), :func:`encode` writes one (the frontend's upload
proxy, the speech client, the evaluation harness's client)."""
from __future__ import annotations

import uuid
from email.parser import BytesParser
from email.policy import HTTP
from typing import List, Mapping, Optional, Tuple


def parts(content_type: str, body: bytes) -> Optional[List[Tuple[str, Optional[str], bytes]]]:
    """(name, filename or None, bytes) of each field of a
    multipart/form-data body in order (none for a body without parts), or
    None when the content type is not multipart/form-data."""
    if not content_type.lower().startswith("multipart/form-data"):
        return None
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        return []
    return [(part.get_param("name", header="content-disposition"), part.get_filename(),
             part.get_payload(decode=True) or b"") for part in msg.iter_parts()]


def file_field(content_type: str, body: bytes) -> Optional[Tuple[str, bytes]]:
    """(filename, bytes) of the ``file`` field of a multipart/form-data
    body, or None when there is none (or it has no filename)."""
    for name, filename, data in parts(content_type, body) or ():
        if name == "file":
            return (filename, data) if filename else None
    return None


def encode(fields: Mapping[str, str] = (),
           files: Mapping[str, Tuple[str, bytes]] = ()) -> Tuple[bytes, str]:
    """(body, Content-Type) of a form of plain ``fields`` and ``files``
    (``name -> (filename, bytes)``)."""
    boundary = uuid.uuid4().hex
    pieces = []
    for name, value in dict(fields).items():
        pieces.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                      .encode() + str(value).encode() + b"\r\n")
    for name, (filename, data) in dict(files).items():
        quoted = filename.replace("\\", "\\\\").replace('"', '\\"')
        pieces.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                      f'filename="{quoted}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                      .encode() + data + b"\r\n")
    pieces.append(f"--{boundary}--\r\n".encode())
    return b"".join(pieces), f"multipart/form-data; boundary={boundary}"
