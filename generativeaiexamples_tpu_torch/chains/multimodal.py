"""The multimodal RAG chain (``multimodal``, ``multimodal_rag``): the
port's copy of the JAX package's generativeaiexamples_tpu/chains/multimodal.py.

Only .pdf and .pptx are accepted. Text is split 1000/100 by the recursive
character splitter; each PDF table becomes a chunk of pipe-joined rows;
each embedded image goes through ``GraphFlow``: with a VLM endpoint
(``APP_MULTIMODAL_VLM_URL``, an OpenAI-compatible multimodal
``/v1/chat/completions``) the VLM says whether it is a chart, linearizes
a chart to a table that the chain's LLM then explains, and captions
anything else; without one, a local cv2 heuristic captions it. A document
with no text at all is transcribed page image by page image (pytesseract
when importable, else the template OCR of ``retrieval/ocr.py``, else the
VLM) into ``ocr`` chunks. Answers paraphrase the rag template with the
"Relevant documents: … [[QUESTION]] …" framing.

``VLMCaptioner`` posts over ``urllib`` where the JAX client uses
``requests``: an HTTP status of 400 or more raises (``HTTPError``), as
``raise_for_status`` does, and ``GraphFlow`` degrades on it the same way.
Every chunk is embedded by the runtime's embedder and every answer is an
engine stream, on the card unless ``runtime.set_device`` says otherwise.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import urllib.request
from typing import Any, Dict, Generator, List, Optional

from generativeaiexamples_tpu_torch.chains import runtime
from generativeaiexamples_tpu_torch.chains.base import BaseExample
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG, NO_DOCS_MSG
from generativeaiexamples_tpu_torch.config import get_config
from generativeaiexamples_tpu_torch.retrieval.splitter import RecursiveCharacterTextSplitter
from generativeaiexamples_tpu_torch.retrieval.store import Chunk

logger = logging.getLogger(__name__)

COLLECTION = os.getenv("COLLECTION_NAME", "vector_db")


class VLMCaptioner:
    """Caption images through an OpenAI-compatible multimodal endpoint."""

    def __init__(self, server_url: str, model_name: str = "vlm"):
        from generativeaiexamples_tpu_torch.engine.embedder import normalize_v1_url

        self._url = normalize_v1_url(server_url)
        self._model = model_name

    def caption(self, image_bytes: bytes, prompt: str = "Describe this image in detail.") -> str:
        mime = "image/jpeg" if image_bytes.startswith(b"\xff\xd8") else "image/png"
        b64 = base64.b64encode(image_bytes).decode()
        payload = {
            "model": self._model,
            "messages": [
                {
                    "role": "user",
                    "content": [
                        {"type": "text", "text": prompt},
                        {"type": "image_url", "image_url": {"url": f"data:{mime};base64,{b64}"}},
                    ],
                }
            ],
            "max_tokens": 256,
        }
        req = urllib.request.Request(
            f"{self._url}/chat/completions", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        # a status of 400 or more raises urllib.error.HTTPError
        with urllib.request.urlopen(req, timeout=120) as resp:
            return json.loads(resp.read())["choices"][0]["message"]["content"]


def get_captioner() -> Optional[VLMCaptioner]:
    url = os.getenv("APP_MULTIMODAL_VLM_URL", "")
    if url:
        return VLMCaptioner(url, os.getenv("APP_MULTIMODAL_VLM_MODEL", "vlm"))
    return None


class GraphFlow:
    """Chart understanding in three steps: (1) the VLM says whether the
    image is a graph, plot or chart; (2) if so, it linearizes the chart's
    data table; (3) the chain's LLM explains that table in plain English.
    Without a VLM the local cv2 caption stands in; without an LLM answer
    the table alone is the searchable text; an endpoint that fails mid-flow
    degrades to the local caption."""

    DETECT_PROMPT = "Is this image a graph, plot, or chart? Answer yes or no."
    TABLE_PROMPT = (
        "This figure is a chart. Produce the underlying data table it "
        "depicts, one row per line with values separated by ' | '."
    )
    TRANSCRIBE_PROMPT = (
        "Transcribe ALL text visible in this page image verbatim, in "
        "reading order. Output ONLY the transcribed text, no commentary."
    )
    EXPLAIN_SYSTEM = (
        "You describe chart data. Given a linearized data table extracted "
        "from a figure, explain it in plain English so a retrieval system "
        "can index the facts it contains."
    )

    def __init__(self, captioner: Optional[VLMCaptioner] = None, llm: Any = None):
        self._captioner = captioner
        self._llm = llm

    def is_graph(self, image_bytes: bytes) -> bool:
        """The VLM's verdict; the cv2 heuristic without one."""
        if self._captioner is not None:
            verdict = self._captioner.caption(image_bytes, self.DETECT_PROMPT).lower().strip()
            # a leading yes/no decides; only an answer that neither affirms
            # nor denies falls back to keywords ("No, this is not a chart."
            # must not read as a chart)
            if verdict.startswith("yes"):
                return True
            if verdict.startswith("no"):
                return False
            import re

            # word-bounded both ways: "photograph" is not "graph", "denotes"
            # is not "not"
            return not re.search(r"\bnot\b", verdict) and bool(
                re.search(r"\b(graph|plot|chart)s?\b", verdict)
            )
        return "chart" in caption_image_local(image_bytes)

    def describe(self, image_bytes: bytes) -> str:
        """Searchable description of one image via the full flow."""
        if self._captioner is None:
            return caption_image_local(image_bytes)
        try:
            if not self.is_graph(image_bytes):
                return self._captioner.caption(image_bytes)
            table = self._captioner.caption(image_bytes, self.TABLE_PROMPT)
            explained = self._explain(table)
            return f"{explained}\n{table}" if explained else table
        except Exception as exc:  # noqa: BLE001 - endpoint down mid-flow
            logger.warning("graph flow failed (%s); using local caption", exc)
            return caption_image_local(image_bytes)

    def transcribe(self, image_bytes: bytes) -> str:
        """The page's text, verbatim, for a scanned or image-only document:
        local OCR first, else the VLM reads the page; "" when neither
        yields text."""
        text = ocr_image_local(image_bytes)
        if text:
            return text
        if self._captioner is not None:
            try:
                return self._captioner.caption(
                    image_bytes, self.TRANSCRIBE_PROMPT
                ).strip()
            except Exception as exc:  # noqa: BLE001 - endpoint down
                logger.warning("VLM transcription failed: %s", exc)
        return ""

    def _explain(self, table: str) -> str:
        try:
            llm = self._llm or runtime.get_llm(get_config())
            return "".join(
                llm.stream_chat(
                    [
                        ("system", self.EXPLAIN_SYSTEM),
                        ("user", "Explain the following linearized table. " + table),
                    ],
                    max_tokens=256,
                )
            ).strip()
        except Exception as exc:  # noqa: BLE001
            logger.warning("chart explanation failed: %s", exc)
            return ""


def ocr_image_local(image_bytes: bytes) -> str:
    """Local OCR: pytesseract (with cv2 to decode) when importable, else the
    template OCR of retrieval/ocr.py. Best-effort: failures return ""."""
    try:
        import pytesseract
    except ImportError:
        pytesseract = None
    if pytesseract is not None:
        try:
            import cv2
            import numpy as np

            arr = cv2.imdecode(
                np.frombuffer(image_bytes, np.uint8), cv2.IMREAD_GRAYSCALE
            )
            if arr is not None:
                text = str(pytesseract.image_to_string(arr)).strip()
                if text:
                    return text
        except Exception as exc:  # noqa: BLE001 - OCR is best-effort
            logger.warning("pytesseract OCR failed: %s", exc)
    from generativeaiexamples_tpu_torch.retrieval.ocr import recognize_image_bytes

    return recognize_image_bytes(image_bytes).strip()


def caption_image_local(image_bytes: bytes) -> str:
    """A heuristic caption without a VLM, through cv2 ("" without it):
    many straight lines and few colours read as a chart, few colours as a
    graphic, anything else as a photograph."""
    try:
        import cv2
        import numpy as np

        arr = cv2.imdecode(np.frombuffer(image_bytes, np.uint8), cv2.IMREAD_COLOR)
        if arr is None:
            return ""
        h, w = arr.shape[:2]
        if h < 16 or w < 16:
            return ""
        gray = cv2.cvtColor(arr, cv2.COLOR_BGR2GRAY)
        edges = cv2.Canny(gray, 50, 150)
        lines = cv2.HoughLinesP(
            edges, 1, np.pi / 180, threshold=60,
            minLineLength=max(16, min(h, w) // 4), maxLineGap=4,
        )
        n_lines = 0 if lines is None else len(lines)
        sample = arr[:: max(1, h // 64), :: max(1, w // 64)].reshape(-1, 3)
        n_colors = len(np.unique(sample, axis=0))
        if n_lines >= 6 and n_colors <= sample.shape[0] // 4:
            kind = "a chart, diagram, or table with axis/grid lines"
        elif n_colors <= 8:
            kind = "a simple graphic or logo"
        else:
            kind = "a photograph or detailed figure"
        return f"Embedded image ({w}x{h} px), likely {kind}."
    except Exception:  # noqa: BLE001 - captioning is best-effort
        return ""


class MultimodalRAG(BaseExample):
    def ingest_docs(self, filepath: str, filename: str) -> None:
        if not filename.endswith((".pdf", ".pptx")):
            raise ValueError(
                f"{filename} is not a valid PDF/PPTX file. Only PDF/PPTX files are "
                "supported for multimodal rag. The PDF/PPTX files can contain multimodal data."
            )
        try:
            if filename.endswith(".pptx"):
                from generativeaiexamples_tpu_torch.chains.pptx_parser import extract_pptx_text

                text = extract_pptx_text(filepath)
                tables: List[Any] = []
            else:
                from generativeaiexamples_tpu_torch.retrieval.pdf import (
                    extract_pdf_tables,
                    extract_pdf_text,
                    iter_content_streams,
                )

                # decompress each content stream once for both passes
                streams = list(iter_content_streams(filepath))
                text = extract_pdf_text(filepath, streams=streams)
                tables = extract_pdf_tables(filepath, streams=streams)
            image_only = not text.strip()
            if image_only:
                logger.warning(
                    "%s has no extractable text; transcribing page images "
                    "(OCR/VLM) and ingesting captions",
                    filename,
                )
            splitter = RecursiveCharacterTextSplitter(chunk_size=1000, chunk_overlap=100)
            chunks = [
                Chunk(text=piece, source=filename, metadata={"filename": filename})
                for piece in splitter.split_text(text)
            ]
            from generativeaiexamples_tpu_torch.retrieval.pdf import stringify_table

            for i, table in enumerate(tables):
                chunks.append(
                    Chunk(
                        text=f"[table {i} in {filename}]\n{stringify_table(table)}",
                        source=filename,
                        metadata={"filename": filename, "type": "table"},
                    )
                )
            if filename.endswith(".pdf"):
                from generativeaiexamples_tpu_torch.retrieval.pdf import (
                    extract_pdf_images as extract_images,
                )
            else:
                from generativeaiexamples_tpu_torch.chains.pptx_parser import (
                    extract_pptx_images as extract_images,
                )
            flow = GraphFlow(get_captioner())
            for i, img in enumerate(extract_images(filepath)):
                transcript = ""
                if image_only:
                    # a scanned page: its transcription is the body text
                    transcript = flow.transcribe(img)
                    for piece in splitter.split_text(transcript):
                        chunks.append(
                            Chunk(
                                text=piece,
                                source=filename,
                                metadata={"filename": filename, "type": "ocr"},
                            )
                        )
                if transcript:
                    # the page's own text: no caption round trips on top
                    continue
                caption = flow.describe(img)
                if caption:
                    chunks.append(
                        Chunk(
                            text=f"[image {i} in {filename}] {caption}",
                            source=filename,
                            metadata={"filename": filename, "type": "image"},
                        )
                    )
            if not chunks:
                raise ValueError(f"No text extracted from {filename}")
            runtime.index_chunks(chunks, COLLECTION)
        except ValueError:
            raise
        except Exception as exc:  # noqa: BLE001
            logger.error("Failed to ingest document due to exception %s", exc)
            raise ValueError(
                "Failed to upload document. Please upload an unstructured text document."
            ) from exc

    def llm_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        config = get_config()
        messages = [("system", config.prompts.chat_template), ("user", query)]
        return runtime.get_llm(config).stream_chat(messages, **runtime.llm_settings(kwargs))

    def rag_chain(self, query: str, chat_history: List[Any], **kwargs: Any
                  ) -> Generator[str, None, None]:
        config = get_config()
        try:
            hits = runtime.retrieve(query, collection=COLLECTION, config=config)
            if not hits:
                logger.warning("Retrieval failed to get any relevant context")
                return iter([NO_CONTEXT_MSG])
            docs = " ".join(h.chunk.text for h in hits)
            augmented = "Relevant documents:" + docs + "\n\n[[QUESTION]]\n\n" + query
            messages = [("system", config.prompts.rag_template), ("user", augmented)]
            return runtime.get_llm(config).stream_chat(messages, **runtime.llm_settings(kwargs))
        except Exception as exc:  # noqa: BLE001
            logger.warning("Failed to generate response due to exception %s", exc)
        return iter([NO_DOCS_MSG])

    def document_search(self, content: str, num_docs: int) -> List[Dict[str, Any]]:
        try:
            hits = runtime.retrieve(content, top_k=num_docs, score_threshold=0.0,
                                    collection=COLLECTION)
            return [
                {
                    "source": h.chunk.metadata.get("filename", h.chunk.source),
                    "content": h.chunk.text,
                    "score": h.score,
                }
                for h in hits
            ]
        except Exception as exc:  # noqa: BLE001
            logger.error("Error from document_search: %s", exc)
            return []

    def get_documents(self) -> List[str]:
        return runtime.get_vector_store(COLLECTION).sources()

    def delete_documents(self, filenames: List[str]) -> bool:
        return runtime.delete_documents(filenames, COLLECTION)
