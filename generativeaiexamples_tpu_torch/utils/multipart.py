"""multipart/form-data bodies over the standard library's email parser:
:func:`file_field` reads the ``file`` field of one (the chain server's and
the frontend's uploads), :func:`encode` writes one (the frontend's upload
proxy, the speech client)."""
from __future__ import annotations

import uuid
from email.parser import BytesParser
from email.policy import HTTP
from typing import Mapping, Optional, Tuple


def file_field(content_type: str, body: bytes) -> Optional[Tuple[str, bytes]]:
    """(filename, bytes) of the ``file`` field of a multipart/form-data
    body, or None when there is none (or it has no filename)."""
    if not content_type.lower().startswith("multipart/form-data"):
        return None
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        return None
    for part in msg.iter_parts():
        if part.get_param("name", header="content-disposition") != "file":
            continue
        filename = part.get_filename()
        if not filename:
            return None
        return filename, part.get_payload(decode=True) or b""
    return None


def encode(fields: Mapping[str, str] = (),
           files: Mapping[str, Tuple[str, bytes]] = ()) -> Tuple[bytes, str]:
    """(body, Content-Type) of a form of plain ``fields`` and ``files``
    (``name -> (filename, bytes)``)."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, value in dict(fields).items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                     .encode() + str(value).encode() + b"\r\n")
    for name, (filename, data) in dict(files).items():
        quoted = filename.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                     f'filename="{quoted}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                     .encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"
