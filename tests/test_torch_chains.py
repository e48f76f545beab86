"""The port's text chains (generativeaiexamples_tpu_torch/chains/
{simple_rag,api_catalog,multi_turn,query_decomposition}.py) and its remote
ranking client against the JAX package's on the CPU.

Both packages ingest the same files through their own runtimes
(``HashEmbedder``, bitwise the same; the ``overlap`` reranker, pure
numpy), and each chain gets its own copy of one scripted LLM (replies
queued, as JAX's tests/test_chains.py scripts them) through
``runtime.get_llm``. Compared exactly:

- the chunks each store and BM25 index hold (``simple_rag``'s 2000/200
  character splitter, ``conv_store`` after three turns);
- the message lists each chain hands the LLM, and the streamed answers;
- the fallbacks: degraded answers (and no memory written for a degraded
  turn), ``NO_CONTEXT_MSG``, ``NO_DOCS_MSG``, ``api_catalog``'s retry
  without the threshold on ``NotImplementedError``;
- ``query_decomposition``'s ledger for scripted Search, Math (possible,
  "Not Possible", a bad operator), Nil, invalid-JSON and 3-round replies;
- ``RemoteReranker``'s request bodies and scores against a stub
  ``/v1/ranking`` server, and its ``ValueError`` without a URL.

Retrieval's own parity, ties of the dense leg included, is
tests/test_torch_chain_runtime.py's. The corpora here are small enough
(one chunk a document for the agent's unfiltered searches) that no two
candidates tie, so both packages retrieve the same chunks in the same
order and the chains can be compared outright.

The registry resolves every name of the JAX registry (``available_examples``,
``register_example`` and the package's exports as in JAX).

Last, the locks the port added where the JAX package has none: BM25 under
concurrent writers and searchers, the runtime's per-collection factories
under concurrent first calls, and four concurrent ``multi_turn``
conversations writing their memory.
"""
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from generativeaiexamples_tpu.chains import api_catalog as japi
from generativeaiexamples_tpu.chains import multi_turn as jmt
from generativeaiexamples_tpu.chains import query_decomposition as jqd
from generativeaiexamples_tpu.chains import runtime as jrt
from generativeaiexamples_tpu.chains import simple_rag as jsr
from generativeaiexamples_tpu.chains.registry import available_examples as javailable_examples
from generativeaiexamples_tpu.config import get_config as jget_config
from generativeaiexamples_tpu.engine import reranker as jreranker
from generativeaiexamples_tpu.retrieval import splitter as jsplitter
from generativeaiexamples_tpu.utils import resilience as jres
from generativeaiexamples_tpu_torch import config as tconfig
from generativeaiexamples_tpu_torch.chains import api_catalog as tapi
from generativeaiexamples_tpu_torch.chains import multi_turn as tmt
from generativeaiexamples_tpu_torch.chains import query_decomposition as tqd
from generativeaiexamples_tpu_torch.chains import runtime as trt
from generativeaiexamples_tpu_torch.chains import simple_rag as tsr
from generativeaiexamples_tpu_torch.chains.developer_rag import NO_CONTEXT_MSG, NO_DOCS_MSG
from generativeaiexamples_tpu_torch.engine import reranker as treranker
from generativeaiexamples_tpu_torch.retrieval import bm25 as tbm25
from generativeaiexamples_tpu_torch.retrieval import splitter as tsplitter
from generativeaiexamples_tpu_torch.retrieval.store import Chunk
from generativeaiexamples_tpu_torch.utils import resilience as tres

JAX = {"rt": jrt, "simple_rag": jsr.SimpleRAG, "api_catalog": japi.APICatalogChatbot,
       "multi_turn": jmt.MultiTurnChatbot, "qd": jqd, "res": jres}
PORT = {"rt": trt, "simple_rag": tsr.SimpleRAG, "api_catalog": tapi.APICatalogChatbot,
        "multi_turn": tmt.MultiTurnChatbot, "qd": tqd, "res": tres}

_ENV = {
    "APP_EMBEDDINGS_MODELENGINE": "hash",
    "APP_EMBEDDINGS_DIMENSIONS": "256",
    "APP_RANKING_MODELENGINE": "overlap",
    "APP_LLM_MODELENGINE": "echo",
    "APP_BATCHING_ENABLE": "off",
}


class ScriptedLLM:
    """Queued replies: ``complete`` returns the next, ``stream_chat`` streams
    it word by word. Records every call's kind and messages, and whether a
    stream was closed."""

    def __init__(self, replies):
        self.replies = list(replies)
        self.calls = []
        self.closed = 0

    def _next(self, kind, messages, kwargs):
        self.calls.append((kind, [tuple(m) for m in messages], sorted(kwargs)))
        return self.replies.pop(0) if self.replies else "(exhausted)"

    def complete(self, messages, **kwargs):
        return self._next("complete", messages, kwargs)

    def stream_chat(self, messages, **kwargs):
        reply = self._next("stream", messages, kwargs)
        llm = self

        def gen():
            try:
                for word in reply.split(" "):
                    yield word + " "
            finally:
                llm.closed += 1

        return gen()


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """Both runtimes from one APP_* environment, each with its own store
    directory; ``script(replies)`` gives each package's runtime its own
    ScriptedLLM and returns (jax's, port's)."""
    for key in list(os.environ):
        if key.startswith("APP_"):
            monkeypatch.delenv(key)
    for key, value in _ENV.items():
        monkeypatch.setenv(key, value)
    jrt.reset_runtime()
    trt.reset_runtime()
    trt.set_device("cpu")
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "jax"))
    jcfg = jget_config()
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path / "port"))
    tcfg = tconfig.get_config()

    def script(replies):
        llms = ScriptedLLM(replies), ScriptedLLM(replies)
        monkeypatch.setattr(jrt, "get_llm", lambda *a, **k: llms[0])
        monkeypatch.setattr(trt, "get_llm", lambda *a, **k: llms[1])
        return llms

    try:
        yield jcfg, tcfg, script
    finally:
        jrt.reset_runtime()
        trt.reset_runtime()
        trt.set_device(None)
        jget_config.cache_clear()
        tconfig.get_config.cache_clear()


def _doc(seed, n_sentences, vocab):
    rng = np.random.default_rng(seed)
    return " ".join(" ".join(rng.choice(vocab, int(rng.integers(6, 12)))) + "."
                    for _ in range(n_sentences))


def _vocab(seed, n):
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    return sorted({"".join(rng.choice(letters, int(rng.integers(4, 9)))) for _ in range(n)})


def _ingest_both(chains, tmp_path, files):
    for name, text in files.items():
        path = tmp_path / name
        path.write_text(text)
        for chain in chains:
            chain.ingest_docs(str(path), name)


def _run_both(jchain, tchain, method, *args, **kwargs):
    """``method`` of both chains on the same arguments, consumed; the
    port's answer (equal to JAX's, DegradedWarnings compared by text)."""
    want = [str(x) for x in getattr(jchain, method)(*args, **kwargs)]
    got = list(getattr(tchain, method)(*args, **kwargs))
    assert [str(x) for x in got] == want
    return got


def _texts(store):
    return [(c.source, c.text) for c in store._chunks]


def _raising(exc):
    def retrieve(*args, **kwargs):
        raise exc

    return retrieve


# --------------------------------------------------------------------------- #
# simple_rag


def test_simple_rag_matches_jax(pair, tmp_path, monkeypatch):
    jcfg, tcfg, script = pair
    vocab = _vocab(1, 60)
    files = {"long.txt": "\n\n".join(_doc(s, 14, vocab) for s in range(4)),
             "notes.md": "# Notes\n\n" + _doc(9, 5, vocab), "short.txt": _doc(10, 2, vocab)}
    jchain, tchain = jsr.SimpleRAG(), tsr.SimpleRAG()
    _ingest_both((jchain, tchain), tmp_path, files)
    # the chunks: 2000/200 characters, in the store and in BM25
    got = _texts(trt.get_vector_store("simple_rag"))
    assert got == _texts(jrt.get_vector_store("simple_rag"))
    assert _texts(trt.get_bm25_index("simple_rag")) == got
    text = (tmp_path / "long.txt").read_text()
    assert [t for s, t in got if s == "long.txt"] == \
        jsplitter.RecursiveCharacterTextSplitter(2000, 200).split_text(text) == \
        tsplitter.RecursiveCharacterTextSplitter(2000, 200).split_text(text)
    assert len([1 for s, _ in got if s == "long.txt"]) > 1
    assert trt.get_vector_store("default").count() == 0  # its own collection
    assert tchain.get_documents() == jchain.get_documents() == list(files)

    history = [{"role": "user", "content": "earlier"}]
    queries = [files["notes.md"].split(".")[1], files["short.txt"][:30], "zzz nothing"]
    for query in queries:
        jllm, tllm = script(["an answer from the context"])
        assert _run_both(jchain, tchain, "rag_chain", query, history, max_tokens=9) == \
            ["an ", "answer ", "from ", "the ", "context "]
        assert tllm.calls == jllm.calls
        (_, messages, settings), = tllm.calls
        assert messages[0] == ("system", tsr.PROMPT) and settings == ["max_tokens", "prefix_hint"]
        assert _run_both(jchain, tchain, "document_search", query, 3) is not None
    jllm, tllm = script(["plain"])
    _run_both(jchain, tchain, "llm_chain", "hello", history)
    assert tllm.calls == jllm.calls == [("stream", [("system", tsr.PROMPT), ("user", "hello")],
                                          ["prefix_hint"])]

    # retrieval down: the degraded answer; resilience off: the error itself
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", _raising(RuntimeError("store down")))
    jllm, tllm = script(["llm only"])
    got = _run_both(jchain, tchain, "rag_chain", "q", [])
    assert isinstance(got[0], trt.DegradedWarning) and got[1:] == ["llm ", "only "]
    assert tllm.calls == jllm.calls
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", _raising(pkg["res"].DeadlineExceeded("late")))
        with pytest.raises(pkg["res"].DeadlineExceeded):
            pkg["simple_rag"]().rag_chain("q", [])
    monkeypatch.setenv("APP_RESILIENCE_ENABLE", "off")
    jget_config.cache_clear()
    tconfig.get_config.cache_clear()
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", _raising(RuntimeError("store down")))
        with pytest.raises(RuntimeError, match="store down"):
            pkg["simple_rag"]().rag_chain("q", [])
        with pytest.raises(RuntimeError, match="store down"):  # no try in document_search
            pkg["simple_rag"]().document_search("q", 2)

    assert tchain.delete_documents(["long.txt"]) == jchain.delete_documents(["long.txt"])
    assert _texts(trt.get_vector_store("simple_rag")) == _texts(jrt.get_vector_store("simple_rag"))
    assert _texts(trt.get_bm25_index("simple_rag")) == _texts(jrt.get_bm25_index("simple_rag"))


# --------------------------------------------------------------------------- #
# api_catalog


def test_api_catalog_matches_jax(pair, tmp_path, monkeypatch):
    jcfg, tcfg, script = pair
    vocab = _vocab(2, 50)
    files = {f"doc{i}.txt": _doc(20 + i, 8, vocab) for i in range(3)}
    jchain, tchain = japi.APICatalogChatbot(), tapi.APICatalogChatbot()
    _ingest_both((jchain, tchain), tmp_path, files)
    history = [{"role": "user", "content": "first"}, {"role": "assistant", "content": "reply"}]
    query = files["doc1.txt"].split(".")[2]
    jllm, tllm = script(["catalog answer"])
    _run_both(jchain, tchain, "rag_chain", query, history, temperature=0.3, max_tokens=5)
    assert tllm.calls == jllm.calls
    (_, messages, _), = tllm.calls
    # chat history stays out of rag_chain; the context ends each chunk with a blank line
    assert [r for r, _ in messages] == ["system", "user"] and \
        messages[0][1] == tcfg.prompts.rag_template
    assert messages[1][1].startswith("Context: ") and messages[1][1].endswith(
        "\n\n\n\nQuestion: " + query + "\n")
    jllm, tllm = script(["chat"])
    _run_both(jchain, tchain, "llm_chain", "hi", history)
    assert tllm.calls == jllm.calls and len(tllm.calls[0][1]) == 4  # history kept here

    # a store without thresholded search: retried with score_threshold 0.0
    calls = {"jax": [], "port": []}
    for key, pkg in (("jax", JAX), ("port", PORT)):
        real = pkg["rt"].retrieve

        def retry(query, *args, _real=real, _calls=calls[key], **kwargs):
            _calls.append(kwargs.get("score_threshold"))
            if kwargs.get("score_threshold") is None:
                raise NotImplementedError("no thresholded search")
            return _real(query, *args, **kwargs)

        monkeypatch.setattr(pkg["rt"], "retrieve", retry)
    jllm, tllm = script(["retried"])
    _run_both(jchain, tchain, "rag_chain", query, [])
    assert calls["port"] == calls["jax"] == [None, 0.0]
    assert tllm.calls == jllm.calls and tllm.calls[0][1][1][1].startswith("Context: ")

    # nothing retrieved, and retrieval failing: the canned messages
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", lambda *a, **k: [])
    assert _run_both(jchain, tchain, "rag_chain", "q", []) == [NO_CONTEXT_MSG]
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", _raising(RuntimeError("down")))
    assert _run_both(jchain, tchain, "rag_chain", "q", []) == [NO_DOCS_MSG]
    assert _run_both(jchain, tchain, "document_search", "q", 4) == []


def test_api_catalog_ingest_failure_matches_jax(pair, tmp_path):
    path = tmp_path / "blank.txt"
    path.write_text("   ")
    for chain in (japi.APICatalogChatbot(), tapi.APICatalogChatbot()):
        with pytest.raises(ValueError, match="Please upload an unstructured text document"):
            chain.ingest_docs(str(path), "blank.txt")


# --------------------------------------------------------------------------- #
# multi_turn


def _turns(files):
    return [files["a.txt"].split(".")[0], files["a.txt"].split(".")[3], files["b.md"].split(".")[2]]


def test_multi_turn_matches_jax(pair, tmp_path, monkeypatch):
    jcfg, tcfg, script = pair
    vocab = _vocab(3, 50)
    files = {"a.txt": _doc(30, 10, vocab), "b.md": "# B\n\n" + _doc(31, 8, vocab)}
    jchain, tchain = jmt.MultiTurnChatbot(), tmt.MultiTurnChatbot()
    _ingest_both((jchain, tchain), tmp_path, files)
    assert trt.get_vector_store("conv_store").count() == 0
    history = []
    for turn, query in enumerate(_turns(files)):
        jllm, tllm = script([f"answer number {turn}"])
        got = _run_both(jchain, tchain, "rag_chain", query, list(history), max_tokens=16)
        assert tllm.calls == jllm.calls
        (_, messages, settings), = tllm.calls
        assert len(messages) == 1 and messages[0][0] == "user"
        assert messages[0][1].endswith("User Query: " + query)
        assert messages[0][1].startswith(tcfg.prompts.multi_turn_rag_template.split("{input}")[0])
        assert settings == ["max_tokens", "prefix_hint"]
        history += [{"role": "user", "content": query},
                    {"role": "assistant", "content": "".join(got)}]
    # the memory: two chunks a turn, in the store and in BM25, equal to JAX's
    conv = _texts(trt.get_vector_store("conv_store"))
    assert conv == _texts(jrt.get_vector_store("conv_store")) == \
        _texts(trt.get_bm25_index("conv_store")) == _texts(jrt.get_bm25_index("conv_store"))
    assert [t for _, t in conv] == [
        line for turn, query in enumerate(_turns(files))
        for line in (f"User previously responded with {query}",
                     f"Agent previously responded with answer number {turn} ")]
    # a later turn's prompt holds the memory of an earlier one
    jllm, tllm = script(["again"])
    _run_both(jchain, tchain, "rag_chain", _turns(files)[0], history)
    assert f"User previously responded with {_turns(files)[0]}" in tllm.calls[0][1][0][1]
    assert tllm.calls == jllm.calls
    n = len(conv) + 2

    # a consumer that stops early: the stream is closed, no memory is written
    for pkg in (JAX, PORT):
        llm = ScriptedLLM(["a b c d"])
        monkeypatch.setattr(pkg["rt"], "get_llm", lambda *a, _l=llm, **k: _l)
        gen = pkg["multi_turn"]().rag_chain(_turns(files)[1], [])
        assert next(gen) == "a "
        gen.close()
        assert llm.closed == 1 and pkg["rt"].get_vector_store("conv_store").count() == n

    # a degraded turn answers LLM-only and writes no memory
    jllm, tllm = script(["degraded reply"])
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", _raising(RuntimeError("store down")))
    got = _run_both(jchain, tchain, "rag_chain", "q", history)
    assert isinstance(got[0], trt.DegradedWarning) and tllm.calls == jllm.calls
    assert tllm.calls[0][1] == [("system", tcfg.prompts.chat_template), ("user", "q")]
    assert trt.get_vector_store("conv_store").count() == \
        jrt.get_vector_store("conv_store").count() == n
    # nothing in either collection: the no-context message
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", lambda *a, **k: [])
    assert _run_both(jchain, tchain, "rag_chain", "q", []) == [NO_CONTEXT_MSG]


def test_multi_turn_first_turn_over_an_empty_memory(pair, tmp_path):
    """conv_store is empty on a first turn: its retrieval is [] and the
    turn answers from the documents."""
    jcfg, tcfg, script = pair
    files = {"a.txt": _doc(32, 6, _vocab(4, 40))}
    jchain, tchain = jmt.MultiTurnChatbot(), tmt.MultiTurnChatbot()
    _ingest_both((jchain, tchain), tmp_path, files)
    query = files["a.txt"].split(".")[1]
    assert trt.retrieve(query, collection="conv_store") == []
    assert jrt.retrieve(query, collection="conv_store") == []
    jllm, tllm = script(["first"])
    assert _run_both(jchain, tchain, "rag_chain", query, []) == ["first "]
    assert "Conversation History Retrieved:\n\n\n" in tllm.calls[0][1][0][1]
    assert tllm.calls == jllm.calls


@pytest.mark.parametrize("name", ["notes.exe", "deck.pptx", "a.txt.bak"])
def test_multi_turn_refuses_other_suffixes(name):
    for cls in (jmt.MultiTurnChatbot, tmt.MultiTurnChatbot):
        with pytest.raises(ValueError, match=f"{name} is not a valid Text, PDF or Markdown file"):
            cls().ingest_docs("/nonexistent/" + name, name)


def test_save_memory_into_a_given_store(pair):
    jcfg, tcfg, script = pair
    store = trt.get_vector_store("elsewhere")
    out = tmt.MultiTurnChatbot().save_memory_and_get_output({"input": "q", "output": "a"}, store)
    assert out == "a" and _texts(store) == [("conversation", "User previously responded with q"),
                                            ("conversation", "Agent previously responded with a")]
    assert trt.get_vector_store("conv_store").count() == 0


# --------------------------------------------------------------------------- #
# query_decomposition

_QD_FILES = {
    "alice.txt": "Alice has 3 apples in her kitchen. Alice also keeps two pears.",
    "bob.txt": "Bob has 5 apples in his basket. Bob sold every pear he had last week.",
    "carol.txt": "Carol counts oranges at the market every morning.",
}
_QUESTION = "How many apples do Alice and Bob have together?"
_SEARCH = ('{"Tool_Request": "Search", "Generated Sub Questions": '
           '["How many apples does Alice have?", "How many apples does Bob have?"]}')
_MATH = '{"Tool_Request": "Math", "Generated Sub Questions": ["What is 3 + 5?"]}'
_QD_SCENARIOS = {
    "search_then_math": [_SEARCH, "3", "5", _MATH,
                         '{"IsPossible": "Possible", "variable1": [3], "variable2": [5], '
                         '"operation": ["+"]}', "Alice and Bob have 8 apples."],
    "math_not_possible": [_MATH, 'Sure: {"IsPossible": "Not Possible"}', "eight", "8 apples"],
    "math_bad_operator": [_MATH, '{"IsPossible": "Possible", "variable1": "3", "variable2": 5,'
                          ' "operation": "^"}', "243", "final"],
    "math_comparison": [_MATH, '{"IsPossible": "Possible", "variable1": 5, "variable2": [3],'
                        ' "operation": ">="}', "yes"],
    "nil": ['{"Tool_Request": "Nil", "Generated Sub Questions": []}', "both", "final"],
    "unknown_tool": ['{"Tool_Request": "Calendar", "Generated Sub Questions": ["when?"]}',
                     "extracted", "final"],
    "invalid_json": ["I think the answer is 8 {not json}", "extracted", "final"],
    "string_sub_question": ['{"Tool_Request": "Search", "Generated Sub Questions": '
                            '"How many apples does Bob have?"}', "5",
                            '{"Tool_Request": "Nil"}', "final"],
    "three_rounds": [_SEARCH, "3", "5", _SEARCH, "3", "5", _SEARCH, "3", "5", "final"],
}


@pytest.mark.parametrize("scenario", list(_QD_SCENARIOS))
def test_query_decomposition_ledger_matches_jax(pair, tmp_path, scenario):
    jcfg, tcfg, script = pair
    jchain, tchain = jqd.QueryDecompositionChatbot(), tqd.QueryDecompositionChatbot()
    _ingest_both((jchain, tchain), tmp_path, _QD_FILES)
    jllm, tllm = script(_QD_SCENARIOS[scenario])
    got = _run_both(jchain, tchain, "rag_chain", _QUESTION, [], max_tokens=32, top_p=0.5)
    for attr in ("question_trace", "answer_trace", "trace", "done"):
        assert getattr(tchain.ledger, attr) == getattr(jchain.ledger, attr), attr
    assert tllm.calls == jllm.calls
    assert not tllm.replies  # every scripted reply was asked for
    kinds = [kind for kind, _, _ in tllm.calls]
    assert kinds[-1] == "stream" and set(kinds[:-1]) == {"complete"}
    assert all(settings == ["max_tokens", "top_p"] for _, _, settings in tllm.calls)
    final = tllm.calls[-1][1][0][1]
    assert final.startswith("Question: " + _QUESTION + "\n\nSub Questions and Answers\n")
    assert final.endswith("\nFinal Answer: ") and got
    led = tchain.ledger
    if scenario == "search_then_math":
        assert led.question_trace[-1] == "What is 3 + 5?" and led.answer_trace[-1] == "3.0+5.0=8.0"
    elif scenario == "math_comparison":
        assert led.answer_trace == ["5.0>=3.0=True"]
    elif scenario in ("math_not_possible", "math_bad_operator"):  # the LLM's answer
        assert led.answer_trace == [_QD_SCENARIOS[scenario][2]] and led.done
        assert tllm.calls[2][1][0][1].startswith("Solve this mathematical question:")
    elif scenario in ("nil", "unknown_tool", "invalid_json"):  # the question searched itself
        assert led.question_trace == [_QUESTION] and led.answer_trace == ["both" if scenario ==
                                                                          "nil" else "extracted"]
    elif scenario == "three_rounds":
        assert led.trace == tqd.MAX_RECURSIONS == 3 and not led.done
        assert len(led.question_trace) == 6
        assert "Sub-Question: How many apples does Alice have?\nSub-Answer: 3\n" in \
            tllm.calls[3][1][0][1]  # the second round's decomposition sees the first's answers


def test_query_decomposition_extract_prompt_and_fallbacks_match_jax(pair, tmp_path, monkeypatch):
    jcfg, tcfg, script = pair
    jchain, tchain = jqd.QueryDecompositionChatbot(), tqd.QueryDecompositionChatbot()
    _ingest_both((jchain, tchain), tmp_path, _QD_FILES)
    assert tqd.DECOMPOSITION_TEMPLATE == jqd.DECOMPOSITION_TEMPLATE
    assert tqd.MATH_TOOL_PROMPT == jqd.MATH_TOOL_PROMPT and tqd._SAFE_OPS.keys() == jqd._SAFE_OPS.keys()
    for text in ['x {"a": 1} y', "no braces", '{"a": }', '{"a": [1, {"b": 2}]} tail }']:
        assert tqd._parse_json_block(text) == jqd._parse_json_block(text)
    # the unfiltered retrieval and the extract prompt, passages numbered
    assert tchain.retriever("apples Bob") == jchain.retriever("apples Bob")
    jllm, tllm = script(["x"])
    tchain.extract_answer(["p one", "p two"], "q?")
    jchain.extract_answer(["p one", "p two"], "q?")
    assert tllm.calls == jllm.calls and tllm.calls[0][1][0][1].endswith(
        "Question: q?\n\nPassage 1:\np one\nPassage 2:\np two\n")
    # llm_chain keeps the history
    jllm, tllm = script(["hi"])
    history = [{"role": "assistant", "content": "earlier"}]
    _run_both(jchain, tchain, "llm_chain", "hello", history)
    assert tllm.calls == jllm.calls and len(tllm.calls[0][1]) == 3
    # an agent that fails with ValueError answers the canned sentence
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["rt"], "retrieve", _raising(ValueError("bad")))
    script(["not json"])
    assert _run_both(jchain, tchain, "rag_chain", "q", []) == ["I can't find an answer for that."]
    assert _run_both(jchain, tchain, "document_search", "q", 2) == []


# --------------------------------------------------------------------------- #
# the remote ranking client


class _RankingStub:
    """A NIM ``/v1/ranking`` stub: a passage's logit is its length; every
    other entry carries ``score`` only; entries come back best first."""

    def __init__(self):
        self.bodies = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_POST(self):  # noqa: N802
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                stub.bodies.append((self.path, body))
                ranked = sorted(enumerate(body["passages"]), key=lambda e: -len(e[1]["text"]))
                rankings = [{"index": i, ("logit" if i % 2 == 0 else "score"): len(p["text"]) / 7}
                            for i, p in ranked]
                data = json.dumps({"rankings": rankings}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, name="test-ranking-stub",
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)
        assert not self.thread.is_alive()


@pytest.fixture
def ranking_stub():
    stub = _RankingStub()
    try:
        yield stub
    finally:
        stub.close()


@pytest.mark.parametrize("suffix", ["", "/", "/v1"])
def test_remote_reranker_matches_jax(ranking_stub, suffix):
    passages = ["short", "a much longer passage here", "mid length", "é ü <b>"]
    j = jreranker.RemoteReranker(ranking_stub.url + suffix, "nv-rerank")
    t = treranker.RemoteReranker(ranking_stub.url + suffix, "nv-rerank")
    want = j.score("the query", passages)
    got = t.score("the query", passages)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, np.array([len(p) / 7 for p in passages], np.float32))
    (jpath, jbody), (tpath, tbody) = ranking_stub.bodies
    assert tpath == jpath == "/v1/ranking" and tbody == jbody == {
        "model": "nv-rerank", "query": {"text": "the query"},
        "passages": [{"text": p} for p in passages]}


def test_remote_reranker_from_the_config(ranking_stub, monkeypatch):
    """APP_RANKING_MODELENGINE=remote builds the client; without a URL both
    packages refuse with the same message."""
    monkeypatch.setattr(treranker, "_RERANKER_CACHE", {})
    monkeypatch.setattr(jreranker, "_RERANKER_CACHE", {})
    env = {"APP_RANKING_MODELENGINE": "remote", "APP_RANKING_MODELNAME": "nv-rerank"}
    with pytest.raises(ValueError) as want:
        jreranker.create_reranker(_jax_config(monkeypatch, env))
    with pytest.raises(ValueError) as got:
        treranker.create_reranker(tconfig.AppConfig.from_env(env))
    assert str(got.value) == str(want.value)
    cfg = tconfig.AppConfig.from_env(dict(env, APP_RANKING_SERVERURL=ranking_stub.url))
    rr = treranker.create_reranker(cfg)
    assert isinstance(rr, treranker.RemoteReranker) and treranker.create_reranker(cfg) is rr
    hits = [trt.SearchHit(chunk=Chunk(text=t, source="s"), score=0.0) for t in ("a", "ccc", "bb")]
    assert [h.chunk.text for h in treranker.rerank_hits(rr, "q", hits, 2)] == ["ccc", "bb"]


def _jax_config(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jget_config.cache_clear()
    try:
        return jget_config()
    finally:
        jget_config.cache_clear()


# --------------------------------------------------------------------------- #
# the port's locks (the JAX package shares these races and is not changed)


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(targets, timeout=120):
    errors = []

    def guard(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 - collected and asserted below
            errors.append(repr(exc))

    threads = [threading.Thread(target=guard, args=(fn,), name=f"test-race-{i}", daemon=True)
               for i, fn in enumerate(targets)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout)
    assert not any(th.is_alive() for th in threads)
    return errors


def test_bm25_concurrent_writers_and_searchers(tmp_path, fast_switching):
    """Writers add chunks one at a time (each add persists the sidecar)
    while searchers search: no error, every chunk kept, and the sidecar
    holds them all."""
    index = tbm25.BM25Index(persist_dir=str(tmp_path), collection="conv_store")
    writers, per_writer = 4, 40
    done = threading.Event()

    def writer(w):
        def run():
            for i in range(per_writer):
                index.add([Chunk(text=f"turn w{w} n{i} shared words here", source="conversation")])
        return run

    def searcher():
        while not done.is_set():
            for hit in index.search("shared w1 n3", 8):
                assert 0.0 <= hit.score <= 1.0

    search_errors = []

    def guarded_search():
        try:
            searcher()
        except Exception as exc:  # noqa: BLE001
            search_errors.append(repr(exc))

    search_threads = [threading.Thread(target=guarded_search, name=f"test-bm25-search-{i}",
                                       daemon=True) for i in range(4)]
    for th in search_threads:
        th.start()
    try:
        errors = _run_threads([writer(w) for w in range(writers)])
    finally:
        done.set()
        for th in search_threads:
            th.join(60)
    assert not any(th.is_alive() for th in search_threads)
    assert errors == [] and search_errors == []
    assert index.count() == writers * per_writer
    reloaded = tbm25.BM25Index(persist_dir=str(tmp_path), collection="conv_store")
    assert sorted(c.text for c in reloaded._chunks) == sorted(c.text for c in index._chunks)
    assert not os.path.exists(str(tmp_path / "bm25_conv_store.jsonl.tmp"))


def test_runtime_factories_build_one_store_and_index_per_collection(monkeypatch, tmp_path,
                                                                    fast_switching):
    monkeypatch.setenv("APP_EMBEDDINGS_MODELENGINE", "hash")
    monkeypatch.setenv("APP_VECTORSTORE_PERSISTDIR", str(tmp_path))
    tconfig.get_config.cache_clear()
    trt.reset_runtime()
    trt.set_device("cpu")
    real_store, real_index = trt.create_vector_store, tbm25.BM25Index

    def slow_store(*args, **kwargs):
        time.sleep(0.02)
        return real_store(*args, **kwargs)

    class SlowIndex(real_index):
        def __init__(self, *args, **kwargs):
            time.sleep(0.02)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(trt, "create_vector_store", slow_store)
    monkeypatch.setattr(tbm25, "BM25Index", SlowIndex)
    barrier = threading.Barrier(8)
    got = []

    def first_call():
        barrier.wait(30)
        got.append((trt.get_vector_store("conv_store"), trt.get_bm25_index("conv_store")))

    try:
        assert _run_threads([first_call] * 8) == []
        assert len(got) == 8
        assert len({id(s) for s, _ in got}) == 1 and len({id(b) for _, b in got}) == 1
    finally:
        trt.reset_runtime()
        trt.set_device(None)
        tconfig.get_config.cache_clear()


def test_concurrent_multi_turn_conversations_keep_every_memory(pair, tmp_path, monkeypatch,
                                                               fast_switching):
    """Four conversations of three turns each, concurrently, on the port
    (the echo LLM answers): conv_store ends with 24 chunks in the store
    and in BM25, the sidecar holds them all, and each first question
    finds its own memory."""
    jcfg, tcfg, script = pair
    from generativeaiexamples_tpu_torch.engine.llm_backend import EchoLLMBackend

    monkeypatch.setattr(trt, "get_llm", lambda *a, **k: EchoLLMBackend())
    vocabs = [_vocab(40 + c, 30) for c in range(4)]
    files = {f"conv{c}.txt": _doc(50 + c, 6, vocabs[c]) for c in range(4)}
    _ingest_both((tmt.MultiTurnChatbot(),), tmp_path, files)
    questions = {c: files[f"conv{c}.txt"].split(".")[:3] for c in range(4)}

    def conversation(c):
        def run():
            history = []
            for query in questions[c]:
                answer = "".join(tmt.MultiTurnChatbot().rag_chain(query, list(history),
                                                                  max_tokens=4))
                history += [{"role": "user", "content": query},
                            {"role": "assistant", "content": answer}]
        return run

    assert _run_threads([conversation(c) for c in range(4)]) == []
    assert trt.get_vector_store("conv_store").count() == trt.get_bm25_index("conv_store").count() == 24
    reloaded = tbm25.BM25Index(persist_dir=tcfg.vector_store.persist_dir, collection="conv_store")
    assert reloaded.count() == 24
    for c in range(4):
        hits = trt.retrieve(questions[c][0], collection="conv_store")
        assert f"User previously responded with {questions[c][0]}" in [h.chunk.text for h in hits]


# --------------------------------------------------------------------------- #
# the registry and the package's exports


def test_the_registry_has_the_jax_names_and_exports():
    import generativeaiexamples_tpu.chains as jchains
    import generativeaiexamples_tpu_torch.chains as tchains

    assert set(tchains.available_examples()) == set(jchains.available_examples())
    assert sorted(tchains.__all__) == sorted(jchains.__all__)
    for name in tchains.__all__:
        assert getattr(tchains, name) is not None
    from generativeaiexamples_tpu_torch.chains import registry

    assert not hasattr(registry, "NOT_PORTED")


@pytest.mark.parametrize("name", sorted(javailable_examples()))
def test_every_jax_name_resolves_to_a_chain(name):
    from generativeaiexamples_tpu.chains import resolve_example as jresolve
    from generativeaiexamples_tpu_torch.chains import BaseExample, resolve_example

    cls = resolve_example(name)
    assert {"ingest_docs", "llm_chain", "rag_chain"} <= set(dir(cls))
    assert issubclass(cls, BaseExample) and cls.__name__ == jresolve(name).__name__
    assert cls.__module__.startswith("generativeaiexamples_tpu_torch.chains.")


def test_register_example(monkeypatch):
    from generativeaiexamples_tpu_torch.chains import (
        available_examples,
        register_example,
        registry,
        resolve_example,
    )

    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    register_example("my_chain", "generativeaiexamples_tpu_torch.chains.echo:EchoChain")
    assert available_examples()["my_chain"] == \
        "generativeaiexamples_tpu_torch.chains.echo:EchoChain"
    assert resolve_example("my_chain").__name__ == "EchoChain"
    copy = available_examples()
    copy["other"] = "x:y"
    assert "other" not in available_examples()
    register_example("not_a_chain", "generativeaiexamples_tpu_torch.chains.base:ABC")
    with pytest.raises(ValueError, match="does not implement"):
        resolve_example("not_a_chain")
    with pytest.raises(NotImplementedError, match="Unknown example 'nope'"):
        resolve_example("nope")
