"""The port's multimodal chain (generativeaiexamples_tpu_torch/chains/
multimodal.py) against the JAX package's, on the CPU, at equality.

- ``GraphFlow`` with a scripted captioner (yes, no and ambiguous verdicts,
  a failure mid-flow) and a scripted LLM for ``_explain``: the same
  descriptions, the same prompts to the VLM and messages to the LLM;
  ``transcribe`` through the template OCR, the VLM, and neither.
- ``MultimodalRAG.ingest_docs`` on a text + table + image PDF, an
  image-only PDF and a PPTX, with and without a VLM: each package's
  ``runtime.index_chunks`` is captured and the chunk lists (text, source,
  metadata) must be equal; then, over hash embeddings and the echo LLM,
  ``document_search``, ``rag_chain``, ``get_documents`` and
  ``delete_documents``; the wrong-extension, empty-document and
  unreadable-document errors.
- ``VLMCaptioner`` over urllib against JAX's over requests, both posting to
  one stdlib stub server: the same JSON bodies (the MIME type sniffed from
  the JPEG magic, ``max_tokens`` 256), the same captions, a timeout of
  120 s, and on a 500 both raise and ``GraphFlow`` degrades alike.
- The optional modules hidden through ``sys.modules`` (cv2, PIL, scipy)
  or faked (pytesseract, working and failing): both packages take the
  same branch.
- ``COLLECTION`` read from ``COLLECTION_NAME`` at import, in both after a
  reload.
"""
import importlib
import io
import json
import os
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image, ImageDraw

from generativeaiexamples_tpu.chains import multimodal as jmm
from generativeaiexamples_tpu.chains import runtime as jrt
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.retrieval.ocr import _find_font
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import multimodal as tmm
from generativeaiexamples_tpu_torch.chains import runtime as trt
from generativeaiexamples_tpu_torch.chains.pptx_parser import write_pptx
from generativeaiexamples_tpu_torch.retrieval import pdf as tpdf

TABLE = "Quarter | Sales\nQ1 | 10\nQ2 | 30"
SCAN_LINES = ["Quarterly revenue grew twelve", "percent in the year 2026."]

_ENV = {
    "APP_EMBEDDINGS_MODELENGINE": "hash",
    "APP_EMBEDDINGS_DIMENSIONS": "256",
    "APP_RANKING_MODELENGINE": "overlap",
    "APP_LLM_MODELENGINE": "echo",
    "APP_BATCHING_ENABLE": "off",
}


class ScriptedVLM:
    """Answers the four GraphFlow prompts; records each prompt. ``fail_on``:
    a prompt fragment that raises ConnectionError."""

    def __init__(self, verdict="Yes, a bar chart.", transcript="", fail_on=None):
        self.verdict, self.transcript, self.fail_on = verdict, transcript, fail_on
        self.calls = []

    def caption(self, image_bytes, prompt="Describe this image in detail."):
        self.calls.append((prompt, len(image_bytes)))
        if self.fail_on is not None and self.fail_on in prompt:
            raise ConnectionError("endpoint down")
        if "yes or no" in prompt:
            return self.verdict
        if "data table" in prompt:
            return TABLE
        if "Transcribe" in prompt:
            return self.transcript
        return "A photo of a server rack."


class ScriptedLLM:
    def __init__(self, reply="The table shows sales by quarter.", fail=False):
        self.reply, self.fail, self.calls = reply, fail, []

    def stream_chat(self, messages, **kwargs):
        self.calls.append(([tuple(m) for m in messages], sorted(kwargs.items())))
        if self.fail:
            raise RuntimeError("engine down")
        return iter(w + " " for w in self.reply.split(" "))


def _jpeg(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def _png(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _chart():
    arr = np.full((128, 128, 3), 255, np.uint8)
    arr[:, ::16] = 30
    arr[::16, :] = 30
    return arr


def _photo(seed=0):
    """Smooth colour waves with a little noise: no straight lines, many
    colours, nothing the template OCR reads (seeds 0, 3 and 4)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:96, 0:128].astype(np.float32)
    a, b, c = rng.rand(3) * 0.1 + 0.02
    arr = np.stack([127 + 120 * np.sin(a * x + b * y), 127 + 120 * np.cos(b * x - c * y),
                    127 + 120 * np.sin(c * (x + y))], -1)
    return np.clip(arr + rng.normal(0, 4, arr.shape), 0, 255).astype(np.uint8)


def _scan(lines=SCAN_LINES, size=32, width=900):
    img = Image.new("L", (width, 40 + 60 * len(lines)), 255)
    d = ImageDraw.Draw(img)
    for i, line in enumerate(lines):
        d.text((20, 20 + 60 * i), line, fill=0, font=_find_font(size))
    return np.asarray(img)


def _words(rng, n):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, int(rng.randint(4, 10)))) for _ in range(n)]


def _files(rng):
    """{name: bytes}: a 4-page PDF (prose, a 12 x 5 table, a chart and a
    photo JPEG, a FlateDecode bitmap), an image-only PDF (a scanned page,
    a photo) and a 3-slide PPTX with one image."""
    prose = [" ".join(_words(rng, 10)) + "." for _ in range(30)]
    grid = [_words(rng, 5) for _ in range(12)]
    scan = _scan()
    return {
        "report.pdf": tpdf.write_pdf([
            (tpdf.text_ops(prose), []),
            (tpdf.table_ops(grid), []),
            (tpdf.text_ops(["Figure 1."]), [("jpeg", _jpeg(_chart()), 128, 128)]),
            (b"", [("jpeg", _jpeg(_photo()), 128, 96),
                   ("raw", _photo(1)[:32, :32].tobytes(), 32, 32, 3)]),
        ]),
        "scan.pdf": tpdf.write_pdf([
            (b"", [("raw", scan.tobytes(), scan.shape[1], scan.shape[0], 1)]),
            (b"", [("jpeg", _jpeg(_photo(3)), 128, 96)]),
        ]),
        "deck.pptx": write_pptx([["Quarterly review", " ".join(_words(rng, 6))],
                                 [" ".join(_words(rng, 8))], ["Thanks"]],
                                media={"image1.png": _png(_chart())}),
    }, grid


@pytest.fixture
def env(tmp_path, monkeypatch):
    """Both runtimes from one APP_* environment, each with its own store
    directory; no VLM endpoint."""
    for key in list(os.environ):
        if key.startswith("APP_") or key == "COLLECTION_NAME":
            monkeypatch.delenv(key)
    for key, value in _ENV.items():
        monkeypatch.setenv(key, value)
    jrt.reset_runtime()
    trt.reset_runtime()
    trt.set_device("cpu")
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "jax"))
    jget_config()
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "port"))
    tconfig.get_config()
    try:
        yield monkeypatch
    finally:
        jrt.reset_runtime()
        trt.reset_runtime()
        trt.set_device(None)
        jget_config.cache_clear()


def _chunks(captured):
    return [(c.text, c.source, dict(c.metadata)) for c in captured]


def _ingest_both(monkeypatch, tmp_path, files, vlm=None, llm=None):
    """Each package ingests ``files`` with its index_chunks captured; the
    captured (collection, chunks) per package, and the VLM's and LLM's
    calls per package."""
    out, calls = [], []
    for mod, rt in ((jmm, jrt), (tmm, trt)):
        captured = []
        v = vlm() if vlm else None
        lm = llm() if llm else ScriptedLLM()
        monkeypatch.setattr(rt, "index_chunks",
                            lambda chunks, coll, *a, **k: captured.append((coll, list(chunks))))
        monkeypatch.setattr(mod, "get_captioner", lambda v=v: v)
        monkeypatch.setattr(rt, "get_llm", lambda *a, lm=lm, **k: lm)
        errors = []
        for name, data in files.items():
            path = tmp_path / f"{mod.__name__.split('.')[0]}-{name}"
            path.write_bytes(data)
            try:
                mod.MultimodalRAG().ingest_docs(str(path), name)
            except ValueError as exc:
                errors.append((name, str(exc)))
        out.append(([(coll, _chunks(ch)) for coll, ch in captured], errors))
        calls.append((v.calls if v else None, lm.calls))
    assert out[1] == out[0]
    assert calls[1] == calls[0]
    return out[1], calls[1]


# --------------------------------------------------------------------------- #
# GraphFlow


@pytest.mark.parametrize("verdict", [
    "Yes, a bar chart.", "No.", "no, this is not a chart", "It shows a line graph.",
    "This is not a chart.", "A photograph of a cat.", "Plots of revenue by month",
    "It denotes quarterly sales", "charts", "Not sure.", "",
])
@pytest.mark.parametrize("explain", ["reply", "empty", "fail"])
def test_graph_flow_verdicts(env, verdict, explain):
    outs = []
    for mod in (jmm, tmm):
        vlm = ScriptedVLM(verdict)
        llm = ScriptedLLM("" if explain == "empty" else "The table shows sales.",
                          fail=explain == "fail")
        flow = mod.GraphFlow(vlm, llm)
        outs.append((flow.is_graph(b"img"), flow.describe(_jpeg(_chart())), vlm.calls, llm.calls))
    assert outs[1] == outs[0]


def test_graph_flow_explains_through_the_runtime_llm(env):
    outs = []
    for mod, rt in ((jmm, jrt), (tmm, trt)):
        llm = ScriptedLLM()
        env.setattr(rt, "get_llm", lambda *a, llm=llm, **k: llm)
        outs.append((mod.GraphFlow(ScriptedVLM()).describe(b"img"), llm.calls))
    assert outs[1] == outs[0]
    assert outs[1][0] == "The table shows sales by quarter.\n" + TABLE
    assert outs[1][1][0][1] == [("max_tokens", 256)]


@pytest.mark.parametrize("fail_on", ["yes or no", "data table", "Describe this image"])
def test_graph_flow_failure_mid_flow_degrades_to_the_local_caption(env, fail_on):
    verdict = "No." if fail_on == "Describe this image" else "Yes."
    img = _jpeg(_chart())
    outs = [mod.GraphFlow(ScriptedVLM(verdict, fail_on=fail_on), ScriptedLLM()).describe(img)
            for mod in (jmm, tmm)]
    assert outs[1] == outs[0] == tmm.caption_image_local(img)
    assert outs[1].startswith("Embedded image (128x128 px)")


def test_without_a_vlm_the_local_caption_decides(env):
    for arr in (_chart(), _photo(), np.zeros((8, 8, 3), np.uint8),
                np.full((64, 64, 3), 200, np.uint8)):
        img = _jpeg(arr)
        outs = [(mod.GraphFlow(None).is_graph(img), mod.GraphFlow(None).describe(img),
                 mod.caption_image_local(img)) for mod in (jmm, tmm)]
        assert outs[1] == outs[0]
    assert tmm.caption_image_local(b"not an image") == jmm.caption_image_local(b"not an image") == ""


@pytest.mark.parametrize("case", ["ocr", "vlm", "vlm_fails", "nothing"])
def test_transcribe(env, case):
    img = _png(_scan()) if case == "ocr" else _jpeg(_photo())
    outs = []
    for mod in (jmm, tmm):
        vlm = (None if case == "nothing" else
               ScriptedVLM(transcript="  A scanned page.  ",
                           fail_on="Transcribe" if case == "vlm_fails" else None))
        outs.append((mod.GraphFlow(vlm).transcribe(img), vlm.calls if vlm else None))
    assert outs[1] == outs[0]
    want = {"ocr": "\n".join(SCAN_LINES), "vlm": "A scanned page.", "vlm_fails": "",
            "nothing": ""}[case]
    assert outs[1][0] == want


# --------------------------------------------------------------------------- #
# ingest


@pytest.mark.parametrize("with_vlm", [True, False])
def test_ingest_makes_the_same_chunks(env, tmp_path, with_vlm):
    files, grid = _files(np.random.RandomState(0))
    vlm = (lambda: ScriptedVLM(transcript="unused")) if with_vlm else None
    (captured, errors), _ = _ingest_both(env, tmp_path, files, vlm=vlm)
    assert errors == []
    by_file = {ch[0][1]: ch for _, ch in captured}
    assert [coll for coll, _ in captured] == ["vector_db"] * 3
    kinds = {name: [m.get("type", "text") for _, _, m in ch] for name, ch in by_file.items()}
    assert kinds["report.pdf"].count("table") == 1 and kinds["report.pdf"].count("image") == 3
    # the scanned page reads; the photo's OCR reads nothing, so the VLM
    # transcribes it or, without one, it is captioned
    assert kinds["scan.pdf"] == (["ocr", "ocr"] if with_vlm else ["ocr", "image"])
    assert kinds["deck.pptx"] == ["text", "image"]
    table = [t for t, _, m in by_file["report.pdf"] if m.get("type") == "table"][0]
    assert table == "[table 0 in report.pdf]\n" + "\n".join(" | ".join(r) for r in grid)
    ocr = [t for t, _, m in by_file["scan.pdf"] if m.get("type") == "ocr"][0]
    assert ocr == "\n".join(SCAN_LINES)
    if with_vlm:
        chart = [t for t, _, m in by_file["deck.pptx"] if m.get("type") == "image"][0]
        assert chart == "[image 0 in deck.pptx] The table shows sales by quarter.\n" + TABLE


def test_ingest_through_vlm_transcription(env, tmp_path, monkeypatch):
    """A scanned page the template OCR cannot read is transcribed by the VLM."""
    photo_pdf = tpdf.write_pdf([(b"", [("jpeg", _jpeg(_photo(4)), 128, 96)])])
    (captured, _), (vlm_calls, _) = _ingest_both(
        env, tmp_path, {"photo.pdf": photo_pdf},
        vlm=lambda: ScriptedVLM(transcript="CONTRACT AGREEMENT for warehouse unit 7."))
    assert captured[0][1] == [("CONTRACT AGREEMENT for warehouse unit 7.", "photo.pdf",
                               {"filename": "photo.pdf", "type": "ocr"})]
    assert [p for p, _ in vlm_calls] == [tmm.GraphFlow.TRANSCRIBE_PROMPT]


def test_ingest_errors(env, tmp_path):
    files = {"readme.txt": b"plain text", "empty.pdf": tpdf.write_pdf([(b"", [])]),
             "broken.pptx": b"not a zip"}
    (captured, errors), _ = _ingest_both(env, tmp_path, files)
    assert captured == []
    assert errors == [
        ("readme.txt", "readme.txt is not a valid PDF/PPTX file. Only PDF/PPTX files are "
                       "supported for multimodal rag. The PDF/PPTX files can contain multimodal data."),
        ("empty.pdf", "No text extracted from empty.pdf"),
        ("broken.pptx", "Failed to upload document. Please upload an unstructured text document."),
    ]


def test_rag_chain_and_document_search_over_the_hash_stack(env, tmp_path):
    files, grid = _files(np.random.RandomState(1))
    outs = []
    for mod, rt in ((jmm, jrt), (tmm, trt)):
        bot = mod.MultimodalRAG()
        empty = "".join(bot.rag_chain("anything", [], max_tokens=8))
        for name, data in files.items():
            path = tmp_path / f"{mod.__name__.split('.')[0]}-{name}"
            path.write_bytes(data)
            bot.ingest_docs(str(path), name)
        query = " ".join(grid[3][:3])
        # top 3: the 4th and 5th tie (two photo captions), and each
        # package orders a tie its own way
        search = bot.document_search(query, 3)
        answer = "".join(bot.rag_chain(query, [], max_tokens=40))
        chat = "".join(bot.llm_chain("hello there", [], max_tokens=4))
        docs = sorted(bot.get_documents())
        deleted = bot.delete_documents(["scan.pdf"])
        outs.append((empty, search, answer, chat, docs, deleted, sorted(bot.get_documents()),
                     bot.document_search(query, 2)))
    assert outs[1] == outs[0]
    empty, search, answer = outs[1][:3]
    assert empty in (tmm.NO_CONTEXT_MSG, tmm.NO_DOCS_MSG)
    assert search[0]["source"] == "report.pdf" and search[0]["content"].startswith("[table 0")
    assert answer.startswith("Relevant documents:")
    assert outs[1][4] == ["deck.pptx", "report.pdf", "scan.pdf"]
    assert outs[1][6] == ["deck.pptx", "report.pdf"]


def test_a_failing_retrieval_answers_no_docs_and_searches_nothing(env):
    def boom(*args, **kwargs):
        raise RuntimeError("store down")

    outs = []
    for mod, rt in ((jmm, jrt), (tmm, trt)):
        env.setattr(rt, "retrieve", boom)
        bot = mod.MultimodalRAG()
        outs.append(("".join(bot.rag_chain("q", [])), bot.document_search("q", 3)))
    assert outs[1] == outs[0] == (tmm.NO_DOCS_MSG, [])


# --------------------------------------------------------------------------- #
# the VLM client over urllib against JAX's over requests


class _StubVLM(BaseHTTPRequestHandler):
    bodies: list = []
    status = 200

    def do_POST(self):  # noqa: N802 - http.server's name
        raw = self.rfile.read(int(self.headers["Content-Length"]))
        body = json.loads(raw)
        type(self).bodies.append((self.path, self.headers["Content-Type"], body))
        if type(self).status != 200:
            self.send_response(type(self).status)
            self.end_headers()
            self.wfile.write(b"boom")
            return
        prompt = body["messages"][0]["content"][0]["text"]
        text = "yes" if "yes or no" in prompt else (TABLE if "data table" in prompt else prompt)
        out = json.dumps({"choices": [{"message": {"role": "assistant", "content": text}}]})
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out.encode())

    def log_message(self, *args):
        pass


@pytest.fixture
def stub_vlm():
    _StubVLM.bodies, _StubVLM.status = [], 200
    server = ThreadingHTTPServer(("127.0.0.1", 0), _StubVLM)
    thread = threading.Thread(target=server.serve_forever, name="test-stub-vlm", daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        assert not thread.is_alive()


@pytest.mark.parametrize("suffix", ["", "/", "/v1", "/v1/"])
def test_vlm_client_posts_what_requests_posts(stub_vlm, env, suffix):
    import requests
    import urllib.request

    timeouts = []
    real_post, real_open = requests.post, urllib.request.urlopen
    env.setattr(requests, "post", lambda *a, **k: timeouts.append(("requests", k["timeout"]))
                or real_post(*a, **k))
    env.setattr(urllib.request, "urlopen", lambda *a, **k: timeouts.append(("urllib", k["timeout"]))
                or real_open(*a, **k))
    images = [_jpeg(_chart()), _png(_photo())]
    outs = []
    for mod in (jmm, tmm):
        _StubVLM.bodies = []
        vlm = mod.VLMCaptioner(stub_vlm + suffix, "vlm-test")
        captions = [vlm.caption(img) for img in images] + \
            [vlm.caption(images[0], mod.GraphFlow.DETECT_PROMPT)]
        outs.append((captions, list(_StubVLM.bodies)))
    assert outs[1] == outs[0]
    assert timeouts == [("requests", 120)] * 3 + [("urllib", 120)] * 3
    path, ctype, body = outs[1][1][0]
    assert (path, ctype, body["max_tokens"], body["model"]) == (
        "/v1/chat/completions", "application/json", 256, "vlm-test")
    urls = [b["messages"][0]["content"][1]["image_url"]["url"][:22] for _, _, b in outs[1][1]]
    assert urls == ["data:image/jpeg;base64", "data:image/png;base64,", "data:image/jpeg;base64"]
    assert outs[1][0] == ["Describe this image in detail.", "Describe this image in detail.", "yes"]


def test_vlm_client_raises_on_a_500_and_the_flow_degrades_alike(stub_vlm, env):
    import requests
    import urllib.error

    _StubVLM.status = 500
    img = _jpeg(_chart())
    with pytest.raises(requests.HTTPError):
        jmm.VLMCaptioner(stub_vlm).caption(img)
    with pytest.raises(urllib.error.HTTPError) as exc:
        tmm.VLMCaptioner(stub_vlm).caption(img)
    assert exc.value.code == 500
    outs = [(mod.GraphFlow(mod.VLMCaptioner(stub_vlm), ScriptedLLM()).describe(img),
             mod.GraphFlow(mod.VLMCaptioner(stub_vlm)).transcribe(_jpeg(_photo())))
            for mod in (jmm, tmm)]
    assert outs[1] == outs[0] == (tmm.caption_image_local(img), "")


def test_get_captioner_reads_the_environment(env, stub_vlm):
    assert tmm.get_captioner() is None and jmm.get_captioner() is None
    env.setenv("APP_MULTIMODAL_VLM_URL", stub_vlm)
    env.setenv("APP_MULTIMODAL_VLM_MODEL", "neva")
    j, t = jmm.get_captioner(), tmm.get_captioner()
    assert (t._url, t._model) == (j._url, j._model) == (stub_vlm + "/v1", "neva")


def test_ingest_over_the_stub_vlm(env, tmp_path, stub_vlm):
    """The same chunks from both packages with the VLM behind HTTP."""
    env.setenv("APP_MULTIMODAL_VLM_URL", stub_vlm)
    files, _ = _files(np.random.RandomState(2))
    outs = []
    for mod, rt in ((jmm, jrt), (tmm, trt)):
        captured = []
        _StubVLM.bodies = []
        env.setattr(rt, "index_chunks", lambda ch, coll, *a, **k: captured.append(_chunks(ch)))
        env.setattr(rt, "get_llm", lambda *a, **k: ScriptedLLM())
        for name, data in files.items():
            path = tmp_path / f"{mod.__name__.split('.')[0]}-{name}"
            path.write_bytes(data)
            mod.MultimodalRAG().ingest_docs(str(path), name)
        outs.append((captured, _StubVLM.bodies))
    assert outs[1] == outs[0]
    prompts = [b["messages"][0]["content"][0]["text"] for _, _, b in outs[1][1]]
    # the report's 3 images and the deck's; the scan's pages are transcribed
    assert prompts.count(tmm.GraphFlow.DETECT_PROMPT) == 4
    assert prompts.count(tmm.GraphFlow.TRANSCRIBE_PROMPT) == 1


# --------------------------------------------------------------------------- #
# optional modules


def test_without_cv2_images_have_no_local_caption(env, tmp_path):
    env.setitem(sys.modules, "cv2", None)
    files, _ = _files(np.random.RandomState(3))
    (captured, errors), _ = _ingest_both(env, tmp_path, files)
    assert errors == []
    kinds = [m.get("type", "text") for _, ch in captured for _, _, m in ch]
    assert "image" not in kinds and kinds.count("ocr") == 1
    assert tmm.caption_image_local(_jpeg(_chart())) == ""


def test_without_pil_flate_images_drop_and_ocr_reads_nothing(env, tmp_path):
    files, _ = _files(np.random.RandomState(4))
    env.setitem(sys.modules, "PIL", None)
    (captured, errors), (vlm_calls, _) = _ingest_both(
        env, tmp_path, files, vlm=lambda: ScriptedVLM("No.", transcript="Page read by the VLM."))
    assert errors == []
    by_file = {ch[0][1]: ch for _, ch in captured}
    # the scanned page is a FlateDecode bitmap: gone; the JPEG photo's OCR
    # reads nothing, so the VLM transcribes it
    assert by_file["scan.pdf"] == [("Page read by the VLM.", "scan.pdf",
                                    {"filename": "scan.pdf", "type": "ocr"})]
    assert [m.get("type") for _, _, m in by_file["report.pdf"]].count("image") == 2


def test_without_scipy_the_template_ocr_reads_nothing(env, tmp_path):
    env.setitem(sys.modules, "scipy", None)
    img = _png(_scan())
    outs = [(mod.ocr_image_local(img), mod.GraphFlow(ScriptedVLM(transcript="vlm")).transcribe(img))
            for mod in (jmm, tmm)]
    assert outs[1] == outs[0] == ("", "vlm")


@pytest.mark.parametrize("works", [True, False])
def test_pytesseract_first_when_importable(env, works):
    fake = types.ModuleType("pytesseract")
    seen = []

    def image_to_string(arr):
        seen.append(arr.shape)
        if not works:
            raise RuntimeError("tesseract binary missing")
        return "  text from tesseract \n"

    fake.image_to_string = image_to_string
    env.setitem(sys.modules, "pytesseract", fake)
    img = _png(_scan())
    outs = [mod.ocr_image_local(img) for mod in (jmm, tmm)]
    assert outs[1] == outs[0] == ("text from tesseract" if works else "\n".join(SCAN_LINES))
    assert len(seen) == 2


def test_collection_is_read_at_import(env):
    env.setenv("COLLECTION_NAME", "mm_docs")
    try:
        importlib.reload(jmm)
        importlib.reload(tmm)
        assert jmm.COLLECTION == tmm.COLLECTION == "mm_docs"
    finally:
        env.delenv("COLLECTION_NAME")
        importlib.reload(jmm)
        importlib.reload(tmm)
    assert tmm.COLLECTION == "vector_db"
