"""REST client for the chain-server public API.

Counterpart of generativeaiexamples_tpu/frontend/chat_client.py over
``urllib`` (the JAX client uses ``requests``): ``predict`` streams
``/generate`` SSE frames and yields each answer chunk, ``search``,
``upload_documents``, ``get_uploaded_documents`` and
``delete_documents``, with traceparent injection when tracing is
enabled. An error status raises ``urllib.error.HTTPError`` where the JAX
client raises ``requests.HTTPError``.
"""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Generator, List, Optional, Sequence

from generativeaiexamples_tpu_torch.utils import multipart
from generativeaiexamples_tpu_torch.utils.logging import get_logger
from generativeaiexamples_tpu_torch.utils.tracing import get_tracer

logger = get_logger(__name__)


class ChatClient:
    def __init__(self, server_url: Optional[str] = None, timeout: float = 300.0):
        self.server_url = (
            server_url
            or os.environ.get("APP_SERVERURL", "http://localhost")
        ).rstrip("/")
        port = os.environ.get("APP_SERVERPORT", "")
        if port and ":" not in self.server_url.split("//", 1)[-1]:
            self.server_url = f"{self.server_url}:{port}"
        self.timeout = timeout

    def _headers(self) -> Dict[str, str]:
        return get_tracer().inject({"Content-Type": "application/json"})

    def _open(self, method: str, path: str, data: Optional[bytes] = None,
              headers: Optional[Dict[str, str]] = None):
        req = urllib.request.Request(f"{self.server_url}{path}", data=data,
                                     headers=headers or {}, method=method)
        return urllib.request.urlopen(req, timeout=self.timeout)

    # -- generation ------------------------------------------------------
    def predict(
        self,
        query: str,
        use_knowledge_base: bool = False,
        chat_history: Sequence[Dict] = (),
        **settings,
    ) -> Generator[str, None, None]:
        """Stream answer chunks from POST /generate."""
        messages = list(chat_history) + [{"role": "user", "content": query}]
        payload = {
            "messages": messages,
            "use_knowledge_base": use_knowledge_base,
            **settings,
        }
        with self._open("POST", "/generate", json.dumps(payload).encode(),
                        self._headers()) as resp:
            for raw in resp:
                line = raw.decode("utf-8").rstrip("\r\n")
                if not line or not line.startswith("data: "):
                    continue
                try:
                    frame = json.loads(line[len("data: "):])
                except json.JSONDecodeError:
                    continue
                for choice in frame.get("choices", []):
                    if choice.get("finish_reason") == "[DONE]":
                        return
                    chunk = choice.get("message", {}).get("content", "")
                    if chunk:
                        yield chunk

    # -- knowledge base --------------------------------------------------
    def search(self, query: str, top_k: int = 4) -> List[Dict]:
        with self._open("POST", "/search", json.dumps({"query": query, "top_k": top_k}).encode(),
                        self._headers()) as resp:
            return json.loads(resp.read()).get("chunks", [])

    def upload_documents(self, file_paths: Sequence[str]) -> None:
        for path in file_paths:
            with open(path, "rb") as fh:
                body, ctype = multipart.encode(files={"file": (os.path.basename(path), fh.read())})
            with self._open("POST", "/documents", body, {"Content-Type": ctype}) as resp:
                resp.read()
            logger.info("Uploaded %s", path)

    def get_uploaded_documents(self) -> List[str]:
        with self._open("GET", "/documents") as resp:
            return json.loads(resp.read()).get("documents", [])

    def delete_documents(self, filename: str) -> bool:
        query = urllib.parse.urlencode({"filename": filename})
        try:
            with self._open("DELETE", f"/documents?{query}") as resp:
                resp.read()
                return resp.status == 200
        except urllib.error.HTTPError as exc:
            exc.close()
            return False
