"""The port's RAG evaluation harness (generativeaiexamples_tpu_torch/tools/
evaluation/) against the JAX repository's tools/evaluation/ on the CPU:

- every test of tests/test_evaluation.py on the port;
- the prompts byte for byte, and ``parse_score`` and ``parse_qna_json``
  equal to JAX's on planted replies and on hypothesis-drawn strings;
- ``generate_synthetic_data``, ``eval_ragas`` and ``eval_llm_judge`` fed
  the same rows through the same scripted LLM and each package's
  ``HashEmbedder``: the same prompts handed to the LLM and the same
  results (within 1e-12);
- the rows ``generate_answers`` writes through the port's urllib client
  and through JAX's ``requests`` client against the same live chain
  server (the port's and JAX's aiohttp one), timings aside;
- the CLI in process, ``generate-data`` and ``evaluate`` on the echo LLM
  and hash embeddings, equal files from both packages; with no card and
  no ``--device`` it raises.
"""
import asyncio
import json
import os
import socket
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from generativeaiexamples_tpu.chains import runtime as jruntime
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.engine.embedder import HashEmbedder as JHash
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import runtime as truntime
from generativeaiexamples_tpu_torch.chains.echo import EchoChain as TEcho
from generativeaiexamples_tpu_torch.engine.embedder import HashEmbedder as THash
from generativeaiexamples_tpu_torch.server.api import make_server
from generativeaiexamples_tpu_torch.tools.evaluation import answer_generator as tans
from generativeaiexamples_tpu_torch.tools.evaluation import evaluator as tev
from generativeaiexamples_tpu_torch.tools.evaluation import main as tmain
from generativeaiexamples_tpu_torch.tools.evaluation import synthetic_data_generator as tsyn
from tools.evaluation import answer_generator as jans
from tools.evaluation import evaluator as jev
from tools.evaluation import main as jmain
from tools.evaluation import synthetic_data_generator as jsyn

SCORE_TOL = 1e-12


class FakeJudge:
    """LLM stub returning a fixed reply and recording the prompts."""

    def __init__(self, reply="0.8"):
        self.reply = reply
        self.prompts = []

    def complete(self, messages, **kwargs):
        self.prompts.append(messages[-1][1])
        return self.reply


class FakeEmbedder:
    dimensions = 4

    def embed_documents(self, texts):
        out = []
        for t in texts:
            rng = np.random.default_rng(abs(hash(t)) % (2**32))
            out.append(rng.standard_normal(4).astype(np.float32))
        return np.stack(out)


ROWS = [
    {
        "question": "what is a tpu?",
        "ground_truth_answer": "a tensor processing unit",
        "answer": "a tensor processing unit",
        "contexts": ["TPUs are tensor processing units."],
    }
]

# replies a judge might give: numbers in and out of range, words, nothing
_REPLIES = ("0.85", "Score: 0.5 because", "10", "-3", "Rating: 4", "four", "", "1.0000001",
            "0.2 then 0.9", "-0.0", "5 stars", "[0.7]", "0.", ".5")


class ScriptedLLM:
    """A deterministic LLM: each prompt's reply is picked by a digest of
    the prompt from ``replies``; records every call's messages and
    settings."""

    def __init__(self, replies=_REPLIES):
        self.replies = replies
        self.calls = []

    def complete(self, messages, **kwargs):
        self.calls.append((list(messages), kwargs))
        text = "".join(c for _, c in messages)
        return self.replies[sum(text.encode()) % len(self.replies)]


def _rows(seed, n=6):
    rng = np.random.default_rng(seed)
    vocab = ["tpu", "gpu", "kernel", "cache", "page", "token", "decode", "prefill", "rank", "mesh"]

    def words(k):
        return " ".join(rng.choice(vocab, k))

    rows = []
    for i in range(n):
        row = {"question": words(5) + "?", "answer": words(int(rng.integers(0, 8))),
               "contexts": [words(int(rng.integers(3, 30))) for _ in range(int(rng.integers(0, 4)))]}
        if i % 3:
            row["ground_truth_answer"] = words(int(rng.integers(1, 6)))
        rows.append(row)
    rows.append({"question": "long?", "answer": "x", "ground_truth_answer": "x",
                 "contexts": ["y " * 4000]})  # a context cut at 6000 characters
    return rows


def _close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, list):
            assert got[key] == value, key
        else:
            assert abs(got[key] - value) <= SCORE_TOL, key


# --------------------------------------------------------------------------- #
# tests/test_evaluation.py on the port


def test_parse_score():
    assert tev.parse_score("0.85") == 0.85
    assert tev.parse_score("Score: 0.5 because...") == 0.5
    assert tev.parse_score("10") == 1.0  # clamped
    assert tev.parse_score("Rating: 4", low=1, high=5) == 4.0
    assert tev.parse_score("no number here") is None


def test_parse_qna_json_variants():
    clean = '[{"question": "q1", "answer": "a1"}]'
    assert tsyn.parse_qna_json(clean) == [{"question": "q1", "answer": "a1"}]
    wrapped = 'Here you go:\n[{"question": "q2", "answer": "a2"}]\nHope that helps!'
    assert tsyn.parse_qna_json(wrapped)[0]["question"] == "q2"
    qa_format = "Question: What is X?\nAnswer: X is Y.\n"
    parsed = tsyn.parse_qna_json(qa_format)
    assert parsed and "What is X" in parsed[0]["question"]
    assert tsyn.parse_qna_json("total garbage") == []


def test_eval_ragas_metrics_and_harmonic_mean():
    judge = FakeJudge("0.8")
    results = tev.eval_ragas(ROWS, llm=judge, embedder=FakeEmbedder())
    for metric in ("faithfulness", "answer_relevancy", "context_relevancy",
                   "context_precision", "context_recall"):
        assert results[metric] == 0.8
    assert results["answer_similarity"] == 1.0  # identical answer and ground truth
    assert 0.8 <= results["ragas_score"] <= 1.0
    assert any("TPUs are tensor" in p for p in judge.prompts)


def test_eval_llm_judge_likert():
    results = tev.eval_llm_judge(ROWS, llm=FakeJudge("Rating: 4"))
    assert results["llm_judge_mean"] == 4.0
    assert results["llm_judge_ratings"] == [4.0]


# --------------------------------------------------------------------------- #
# against the JAX harness


def test_prompts_are_jax_s_byte_for_byte():
    assert tev.JUDGE_SCALE_PROMPT == jev.JUDGE_SCALE_PROMPT
    assert tev.CRITERIA == jev.CRITERIA and list(tev.CRITERIA) == list(jev.CRITERIA)
    assert tev.LLM_JUDGE_PROMPT == jev.LLM_JUDGE_PROMPT
    assert tsyn.GENERATION_PROMPT == jsyn.GENERATION_PROMPT


_PLANTED = [
    "0.85", "Score: 0.5 because 0.7", "10", "-4.25 then", "Rating: 4", "", "abc", "1e5", "٣",
    '[{"question": "q", "answer": "a"}]',
    'prose [{"question": "q1", "answer": "a1"}, {"question": 2, "answer": null}] more ]',
    '[{"question": "q"}]', '{"question": "q", "answer": "a"}', "[1, 2]", "[not json]",
    "Q1: What is X?\nA1: X is Y.\nQ2: And Z?\nA2: Z is W.",
    "question: lower? answer: case.", "Q: no answer here", "[] Question: a? Answer: b",
]


@pytest.mark.parametrize("text", _PLANTED)
def test_parsers_equal_jax_s_on_planted_replies(text):
    for low, high in ((0.0, 1.0), (1.0, 5.0)):
        assert tev.parse_score(text, low, high) == jev.parse_score(text, low, high)
    assert tsyn.parse_qna_json(text) == jsyn.parse_qna_json(text)


_PIECES = st.sampled_from(['[', ']', '{', '}', '"question"', '"answer"', ':', ',', '"x"', "Q:",
                           "A:", "Question 2:", "Answer:", "0.5", "-1", "7", " ", "\n", "é"])


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.one_of(st.text(max_size=40), st.lists(_PIECES, max_size=16).map("".join)))
def test_parsers_equal_jax_s_on_drawn_strings(text):
    assert tev.parse_score(text) == jev.parse_score(text)
    assert tev.parse_score(text, 1.0, 5.0) == jev.parse_score(text, 1.0, 5.0)
    assert tsyn.parse_qna_json(text) == jsyn.parse_qna_json(text)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eval_ragas_and_judge_equal_jax_s(seed):
    rows = _rows(seed)
    t_llm, j_llm = ScriptedLLM(), ScriptedLLM()
    got = tev.eval_ragas(rows, llm=t_llm, embedder=THash(dimensions=64))
    want = jev.eval_ragas(rows, llm=j_llm, embedder=JHash(dimensions=64))
    _close(got, want)
    assert t_llm.calls == j_llm.calls
    t_llm, j_llm = ScriptedLLM(), ScriptedLLM()
    _close(tev.eval_llm_judge(rows, llm=t_llm), jev.eval_llm_judge(rows, llm=j_llm))
    assert t_llm.calls == j_llm.calls


def test_eval_results_without_scores_equal_jax_s():
    silent = ScriptedLLM(replies=("no number",))
    rows = _rows(4)
    assert tev.eval_llm_judge(rows, llm=silent) == jev.eval_llm_judge(rows, llm=silent) == {}
    got = tev.eval_ragas(rows, llm=silent, embedder=THash(dimensions=32))
    want = jev.eval_ragas(rows, llm=silent, embedder=JHash(dimensions=32))
    _close(got, want)
    assert set(got) <= {"answer_similarity", "ragas_score"}


def test_synthetic_data_equal_jax_s(tmp_path):
    docs = []
    for i, n in enumerate((40, 900, 1500)):
        path = tmp_path / f"doc{i}.txt"
        path.write_text(" ".join(f"w{i}x{k}" for k in range(n)))
        docs.append(str(path))
    replies = ('[{"question": "q1", "answer": "a1"}, {"question": "q2", "answer": "a2"}, '
               '{"question": "q3", "answer": "a3"}]', "Q: one? A: two.", "nothing")
    t_llm, j_llm = ScriptedLLM(replies), ScriptedLLM(replies)
    got = tsyn.generate_synthetic_data(docs, str(tmp_path / "t" / "qna.json"), llm=t_llm,
                                       chunk_size=300, chunk_overlap=20, max_chunks=3)
    want = jsyn.generate_synthetic_data(docs, str(tmp_path / "j" / "qna.json"), llm=j_llm,
                                        chunk_size=300, chunk_overlap=20, max_chunks=3)
    assert got == want and len(got) > 3
    assert t_llm.calls == j_llm.calls
    assert (tmp_path / "t" / "qna.json").read_bytes() == (tmp_path / "j" / "qna.json").read_bytes()


def test_write_results_equal_jax_s(tmp_path):
    results = {"faithfulness": 0.5, "llm_judge_mean": 4.0, "llm_judge_ratings": [4.0, 4.0]}
    tev.write_results(results, str(tmp_path / "t" / "results.json"))
    jev.write_results(results, str(tmp_path / "j" / "results.json"))
    assert (tmp_path / "t" / "results.json").read_bytes() == \
        (tmp_path / "j" / "results.json").read_bytes()
    assert os.path.exists(tmp_path / "t" / "results.parquet") == \
        os.path.exists(tmp_path / "j" / "results.parquet")


# --------------------------------------------------------------------------- #
# the answer generator against live chain servers


@pytest.fixture
def app_env(monkeypatch, tmp_path):
    """A clean APP_* environment (the echo LLM, hash embeddings), read
    afresh by both packages; the port's runtime on the CPU."""
    for key in list(os.environ):
        if key.startswith("APP_") or key in ("EXAMPLE_NAME", "DOC_UPLOAD_DIR"):
            monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("APP_LLM_MODELENGINE", "echo")
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("DOC_UPLOAD_DIR", str(tmp_path / "uploads"))
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device("cpu")
    yield monkeypatch
    jruntime.reset_runtime()
    truntime.reset_runtime()
    truntime.set_device(None)
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_port(chain):
    server = make_server("127.0.0.1", 0, chain)
    thread = threading.Thread(target=server.serve_forever, name="test-chain-server", daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(30)

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def _serve_jax(chain):
    from aiohttp import web

    from generativeaiexamples_tpu.server.api import create_app

    port = _free_port()
    loop = asyncio.new_event_loop()
    started, box = threading.Event(), {}

    def serve():
        asyncio.set_event_loop(loop)

        async def up():
            runner = web.AppRunner(create_app(chain))
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", port).start()
            box["runner"] = runner
            started.set()

        loop.run_until_complete(up())
        loop.run_forever()
        loop.run_until_complete(box["runner"].cleanup())
        loop.close()

    thread = threading.Thread(target=serve, name="test-jax-chain-server", daemon=True)
    thread.start()
    assert started.wait(10)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)

    return f"http://127.0.0.1:{port}", stop


def _drop_timing(rows):
    return [{k: v for k, v in r.items() if k not in ("latency_s", "ttft_s")} for r in rows]


def test_answer_generator_against_live_server(app_env, tmp_path):
    """The JAX test's scenario, the port's client against the port's
    server."""
    base, stop = _serve_port(type("FreshEcho", (TEcho,), {"documents": {}}))
    try:
        doc = tmp_path / "doc.txt"
        doc.write_text("tpu frameworks use jax and pallas for kernels")
        out = tmp_path / "eval.json"
        rows = tans.generate_answers(
            [{"question": "what do tpu frameworks use?", "ground_truth_answer": "jax"}],
            str(out), server_url=base, docs=[str(doc)], use_knowledge_base=False)
        assert len(rows) == 1
        assert "tpu frameworks" in rows[0]["answer"]
        assert json.loads(out.read_text())[0]["question"].startswith("what do")
        assert json.loads((tmp_path / "eval.json.timing.json").read_text())["questions"] == 1
    finally:
        stop()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_client_rows_equal_jax_client_s(app_env, tmp_path, server):
    from generativeaiexamples_tpu.chains.echo import EchoChain as JEcho

    if server == "port":
        base, stop = _serve_port(type("FreshEcho", (TEcho,), {"documents": {}}))
    else:
        base, stop = _serve_jax(type("FreshEcho", (JEcho,), {"documents": {}}))
    qna = [{"question": "what do tpu frameworks use?", "ground_truth_answer": "jax",
            "ground_truth_context": "ctx"},
           {"question": "a & b <b>bold</b> ü \"q\"", "ground_truth_answer": ""},
           {"question": "plain"}]
    docs = []
    for i in range(2):
        doc = tmp_path / f"doc{i}.txt"
        doc.write_text(f"document {i}: tpu frameworks use jax and pallas for kernels " * (i + 1))
        docs.append(str(doc))
    try:
        for kb in (True, False):
            want = jans.generate_answers(qna, str(tmp_path / "j.json"), server_url=base,
                                         docs=docs, top_k=2, use_knowledge_base=kb)
            got = tans.generate_answers(qna, str(tmp_path / "t.json"), server_url=base,
                                        docs=docs, top_k=2, use_knowledge_base=kb)
            # JAX's client reads the SSE text with requests' default for a
            # text/* type without a charset, ISO-8859-1, where the frames are
            # UTF-8: its non-ASCII answers are mojibake the port does not copy
            for row in want:
                row["answer"] = row["answer"].encode("latin-1").decode("utf-8")
            assert _drop_timing(got) == _drop_timing(want)
            assert all(r["contexts"] for r in got) and got[0]["answer"]
            assert 'ü "q"' in got[1]["answer"]
            assert set(json.loads((tmp_path / "t.json.timing.json").read_text())) == \
                set(json.loads((tmp_path / "j.json.timing.json").read_text()))
        tclient, jclient = tans.ChainServerClient(base), jans.ChainServerClient(base)
        assert tclient.health() is jclient.health() is True
        assert tclient.ready() is jclient.ready() is True
        assert tclient.search("kernels", 1) == jclient.search("kernels", 1)
    finally:
        stop()
    down = f"http://127.0.0.1:{_free_port()}"
    assert tans.ChainServerClient(down).health() is jans.ChainServerClient(down).health() is False
    assert tans.ChainServerClient(down).ready() is jans.ChainServerClient(down).ready() is False
    with pytest.raises(RuntimeError, match="is not healthy"):
        tans.generate_answers(qna, str(tmp_path / "x.json"), server_url=down)


# --------------------------------------------------------------------------- #
# the CLI


def test_cli_generate_data_and_evaluate_equal_jax_s(app_env, tmp_path, capsys):
    doc = tmp_path / "doc.txt"
    doc.write_text("the pump fleet logged 412 errors in january and 388 in february " * 30)
    for pkg, main in (("t", tmain.main), ("j", jmain.main)):
        extra = ["--device", "cpu"] if pkg == "t" else []
        assert main(["generate-data", "--docs", str(doc), "--output",
                     str(tmp_path / pkg / "qna.json"), "--max-chunks", "2"] + extra) == 0
    qna = json.loads((tmp_path / "t" / "qna.json").read_text())
    assert qna and qna == json.loads((tmp_path / "j" / "qna.json").read_text())
    rows = _rows(3) + [{"question": q["question"], "answer": q["ground_truth_answer"],
                        "ground_truth_answer": q["ground_truth_answer"], "contexts": ["c"]}
                       for q in qna]
    (tmp_path / "eval.json").write_text(json.dumps(rows))
    for pkg, main in (("t", tmain.main), ("j", jmain.main)):
        extra = ["--device", "cpu"] if pkg == "t" else []
        assert main(["evaluate", "--eval", str(tmp_path / "eval.json"), "--output",
                     str(tmp_path / pkg / "results.json")] + extra) == 0
    got = json.loads((tmp_path / "t" / "results.json").read_text())
    _close(got, json.loads((tmp_path / "j" / "results.json").read_text()))
    # the echo judge's first 8 words hold no number: no Likert rating
    assert "answer_similarity" in got and "llm_judge_mean" not in got
    assert capsys.readouterr().out.count(f"generated {len(qna)} QnA pairs ->") == 2


def test_cli_raises_with_no_card_and_no_device(app_env, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    truntime.set_device(None)
    (tmp_path / "eval.json").write_text("[]")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["evaluate", "--eval", str(tmp_path / "eval.json"),
                    "--output", str(tmp_path / "r.json")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain.main(["generate-data", "--docs", str(tmp_path / "eval.json")])
    assert not (tmp_path / "r.json").exists()
