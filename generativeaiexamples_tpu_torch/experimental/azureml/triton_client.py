"""A Triton-protocol HTTP client and an LLMBackend over it.

Counterpart of the JAX repository's experimental/azureml/triton_client.py,
on ``urllib``: ``POST {server}/v2/models/{model}/infer`` with KServe-v2
JSON tensors (``text_input`` BYTES, ``max_tokens`` INT32, ``temperature``
FP32, ``runtime_top_k`` INT32, ``runtime_top_p`` FP32, ``beam_width``
INT32, ``repetition_penalty`` FP32, ``len_penalty`` FP32, each of shape
[1, 1]), the reply's ``text_output`` tensor read back (a ``RuntimeError``
when it has none; an HTTP error status raises urllib's ``HTTPError``);
an optional bearer token and extra headers on every request;
``GET /v2/health/ready`` for readiness.
"""
from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Generator, Optional, Sequence, Tuple

from generativeaiexamples_tpu_torch.engine.llm_backend import LLMBackend


def _tensor(name: str, value, datatype: str) -> Dict[str, Any]:
    return {"name": name, "shape": [1, 1], "datatype": datatype, "data": [value]}


class TritonHTTPClient:
    def __init__(
        self,
        server_url: str,
        api_key: Optional[str] = None,
        extra_headers: Optional[Dict[str, str]] = None,
        timeout: float = 300.0,
    ):
        self.server_url = server_url.rstrip("/")
        self.timeout = timeout
        self.headers = {"Content-Type": "application/json"}
        if api_key:
            self.headers["Authorization"] = f"Bearer {api_key}"
        self.headers.update(extra_headers or {})

    def _post(self, path: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        req = urllib.request.Request(
            f"{self.server_url}{path}", data=json.dumps(payload).encode(), headers=self.headers
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read().decode())

    def server_ready(self) -> bool:
        try:
            req = urllib.request.Request(
                f"{self.server_url}/v2/health/ready", headers=self.headers
            )
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status == 200
        except Exception:  # noqa: BLE001 - any failure reads as not ready
            return False

    def infer(
        self,
        model_name: str,
        prompt: str,
        tokens: int = 100,
        temperature: float = 1.0,
        top_k: int = 1,
        top_p: float = 0.0,
        beam_width: int = 1,
        repetition_penalty: float = 1.0,
        length_penalty: float = 1.0,
    ) -> str:
        payload = {
            "inputs": [
                _tensor("text_input", prompt, "BYTES"),
                _tensor("max_tokens", int(tokens), "INT32"),
                _tensor("temperature", float(temperature), "FP32"),
                _tensor("runtime_top_k", int(top_k), "INT32"),
                _tensor("runtime_top_p", float(top_p), "FP32"),
                _tensor("beam_width", int(beam_width), "INT32"),
                _tensor("repetition_penalty", float(repetition_penalty), "FP32"),
                _tensor("len_penalty", float(length_penalty), "FP32"),
            ],
            "outputs": [{"name": "text_output"}],
        }
        body = self._post(f"/v2/models/{model_name}/infer", payload)
        for out in body.get("outputs", []):
            if out.get("name") == "text_output":
                data = out.get("data", [])
                return str(data[0]) if data else ""
        raise RuntimeError(f"No text_output tensor in response: {list(body)}")


class TritonLLMBackend(LLMBackend):
    """The chains' LLM backend over a Triton endpoint: the messages joined
    as ``role: content`` lines, one request, the text cut at the first
    ``stop`` marker it holds, streamed as one chunk."""

    def __init__(self, server_url: str, model_name: str = "ensemble", api_key: Optional[str] = None,
                 extra_headers: Optional[Dict[str, str]] = None):
        self.client = TritonHTTPClient(server_url, api_key=api_key, extra_headers=extra_headers)
        self.model_name = model_name

    def stream_chat(
        self,
        messages: Sequence[Tuple[str, str]],
        temperature: float = 0.2,
        top_p: float = 0.7,
        max_tokens: int = 1024,
        stop: Sequence[str] = (),
        prefix_hint: Optional[str] = None,
        spec_decode: Optional[bool] = None,
    ) -> Generator[str, None, None]:
        # prefix_hint and spec_decode advise an in-process engine; the
        # remote endpoint has no field for either (as in JAX)
        prompt = "\n".join(f"{role}: {content}" for role, content in messages)
        text = self.client.infer(
            self.model_name,
            prompt,
            tokens=max_tokens,
            temperature=temperature,
            top_p=top_p,
        )
        for marker in stop:
            if marker and marker in text:
                text = text.split(marker, 1)[0]
        yield text
